// Kernel 7: baroclinic pressure gradient, splines density Jacobian
// (prsgrd32.h:158-378, Shchepetkin & McWilliams 2003): vertical spline
// derivatives with harmonic-mean limiting, the top-down pressure integral
// and both horizontal density Jacobians, into ru/rv.
//
// Replaces roms_tpu/ops/pallas_prsgrd.py:191 prsgrd32_pallas (pallas_call
// l.249); plain version core/prsgrd.py prsgrd32 (ops/prsgrd.py).  Class:
// EW-periodic, not NS-periodic, no tide/air-pressure/ice-shelf terms.
// Every point carries the plain path's value (jnp.roll wrap in the ring
// rows, which the Pallas kernel zeroes), so the two compare whole.
//
// Bound on the H100: bytes.  It reads rho, z_r, Hz (N levels), the
// surface z_w plane, umask, vmask, on_u, om_v and writes ru, rv (N):
// ~5 words a point against ~150 flops.
//
// Design: one thread per (j, i) column walks k top-down once.  The
// Jacobians at (j, i) need the pressure of the west (j, i-1) and south
// (j-1, i) columns too, so the thread integrates those two columns beside
// its own (three running sums in the plain version's order: the dP
// increments accumulate among themselves and P_top is added per level).
// That triples the vertical arithmetic instead of a second pass through a
// pressure array in device memory; neighbour reuse of the loads comes from
// L1/L2.  The density Jacobian subtracts nearly equal pressures, so every
// product that feeds an add or subtract is mul_rn: each value rounds as
// in the plain version.
#include "common.cuh"

namespace {

using roms::mul_rn;
using roms::wrap;

constexpr double kEps = 1.0e-10;
constexpr double kFifth = 0.2;
constexpr double kTwelfth = 1.0 / 12.0;

template <typename T>
struct Args {
  const T *rho, *z_r, *Hz;   // (N, Mj, Li)
  const T* zw_top;           // z_w[N] (Mj, Li)
  const T *umask, *vmask, *on_u, *om_v;
  T *ru, *rv;
  int N, Mj, Li;
  T gsal, GRho, HalfGRho;    // g*(1-sal_scalar), g/rho0, 0.5*g/rho0
};

// 2ab/(a+b) where 2ab > eps, else 0 (the prsgrd32.h limiter)
template <typename T>
__device__ __forceinline__ T harmonic(T a, T b) {
  const T cff = T(2.0) * a * b;
  return cff > T(kEps) ? cff / (a + b) : T(0);
}

template <typename T>
__device__ __forceinline__ T harmonic_z(T a, T b) {
  return T(2.0) * a * b / (a + b);
}

// Pressure integral of one column, walked from the top down.
template <typename T>
struct Column {
  const T *rho, *zr;   // level 0 of this column
  size_t P;
  int N;
  T Ptop, acc;

  __device__ T r(int k) const { return rho[k * P]; }
  __device__ T z(int k) const { return zr[k * P]; }
  __device__ int cl(int m) const { return m < 0 ? 0 : (m > N - 2 ? N - 2 : m); }
  // dR(m) = rho(m+1) - rho(m) of the padded difference arrays
  __device__ T dRi(int m) const { return r(cl(m) + 1) - r(cl(m)); }
  __device__ T dZi(int m) const { return z(cl(m) + 1) - z(cl(m)); }
  __device__ T dRm(int k) const { return harmonic(dRi(k), dRi(k - 1)); }
  __device__ T dZm(int k) const { return harmonic_z(dZi(k), dZi(k - 1)); }

  __device__ void start(T zw, T gsal, T GRho) {
    const T cff1 = T(1.0) / (z(N - 1) - z(N - 2));
    const T cff2 =
        mul_rn(T(0.5) * (r(N - 1) - r(N - 2)) * (zw - z(N - 1)), cff1);
    Ptop = mul_rn(gsal, zw) + mul_rn(GRho * (r(N - 1) + cff2), zw - z(N - 1));
    acc = T(0);
  }
  // pressure at level k; call for k = N-1, N-2, ..., 0 in turn
  __device__ T pressure(int k, T HalfGRho) {
    if (k == N - 1) return Ptop;
    const T Rm0 = dRm(k), Rm1 = dRm(k + 1), Zm0 = dZm(k), Zm1 = dZm(k + 1);
    const T dz = z(k + 1) - z(k);
    const T X = mul_rn(Rm1 - Rm0, dz - mul_rn(T(kTwelfth), Zm1 + Zm0)) -
                mul_rn(Zm1 - Zm0,
                       r(k + 1) - r(k) - mul_rn(T(kTwelfth), Rm1 + Rm0));
    const T dP = mul_rn(HalfGRho, mul_rn(r(k + 1) + r(k), dz) -
                                      mul_rn(T(kFifth), X));
    acc = k == N - 2 ? dP : acc + dP;
    return Ptop + acc;
  }
};

// (P(m) - P) - HalfGRho*(density Jacobian) between a point and its
// neighbour m of one level; dR, dZ are the limited horizontal differences
template <typename T>
__device__ __forceinline__ T jacobian(T Pm, T P, T r, T rm, T z, T zm, T dR,
                                      T dRm, T dZ, T dZm, T HalfGRho) {
  const T X = mul_rn(dR - dRm, z - zm - mul_rn(T(kTwelfth), dZ + dZm)) -
              mul_rn(dZ - dZm, r - rm - mul_rn(T(kTwelfth), dR + dRm));
  const T Q = mul_rn(r + rm, z - zm) - mul_rn(T(kFifth), X);
  return Pm - P - mul_rn(HalfGRho, Q);
}

template <typename T>
__global__ void prsgrd_kernel(Args<T> a) {
  const int Li = a.Li, Mj = a.Mj, N = a.N;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Mj * Li) return;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const int i = c % Li, j = c / Li;
  const int im = wrap(i - 1, Li), jm = wrap(j - 1, Mj);
  const int cw = j * Li + im, cs = jm * Li + i;
  Column<T> own{a.rho + c, a.z_r + c, P, N};
  Column<T> west{a.rho + cw, a.z_r + cw, P, N};
  Column<T> south{a.rho + cs, a.z_r + cs, P, N};
  own.start(a.zw_top[c], a.gsal, a.GRho);
  west.start(a.zw_top[cw], a.gsal, a.GRho);
  south.start(a.zw_top[cs], a.gsal, a.GRho);
  const T cu = T(0.5) * a.on_u[c];
  const T cv = T(0.5) * a.om_v[c];

  for (int k = N - 1; k >= 0; --k) {
    const T Pc = own.pressure(k, a.HalfGRho);
    const T Pw = west.pressure(k, a.HalfGRho);
    const T Ps = south.pressure(k, a.HalfGRho);
    const T* rl = a.rho + k * P;
    const T* zl = a.z_r + k * P;
    const size_t o = k * P + c;

    // xi direction: aux, FC ringed (periodic lanes), limited, ringed again
    const int row = j * Li;
    auto ax = [&](const T* f, int ii) {   // (f - im1 f)*umask at lane ii
      return mul_rn(f[row + ii] - f[row + wrap(ii - 1, Li)],
                    a.umask[row + ii]);
    };
    auto dx = [&](const T* f, int ii) {   // ringed harmonic at lane ii
      const int p = roms::ring_x(ii, Li, true);
      const int q = roms::ring_x(wrap(p + 1, Li), Li, true);
      return harmonic(ax(f, p), ax(f, q));
    };
    const T gu = jacobian(Pw, Pc, rl[c], rl[cw], zl[c], zl[cw], dx(rl, i),
                          dx(rl, im), dx(zl, i), dx(zl, im), a.HalfGRho);
    a.ru[o] = cu * (a.Hz[o] + a.Hz[k * P + cw]) * gu;

    // eta direction (closed N/S: no ring)
    auto ay = [&](const T* f, int jj) {   // (f - jm1 f)*vmask at row jj
      return mul_rn(f[jj * Li + i] - f[wrap(jj - 1, Mj) * Li + i],
                    a.vmask[jj * Li + i]);
    };
    auto dy = [&](const T* f, int jj) {
      return harmonic(ay(f, jj), ay(f, wrap(jj + 1, Mj)));
    };
    const T gv = jacobian(Ps, Pc, rl[c], rl[cs], zl[c], zl[cs], dy(rl, j),
                          dy(rl, jm), dy(zl, j), dy(zl, jm), a.HalfGRho);
    a.rv[o] = cv * (a.Hz[o] + a.Hz[k * P + cs]) * gv;
  }
}

template <typename T>
int launch(const void* rho, const void* z_r, const void* Hz,
           const void* zw_top, const void* umask, const void* vmask,
           const void* on_u, const void* om_v, void* ru, void* rv, int N,
           int Mj, int Li, double gsal, double GRho, double HalfGRho,
           void* stream) {
  Args<T> a{static_cast<const T*>(rho),   static_cast<const T*>(z_r),
            static_cast<const T*>(Hz),    static_cast<const T*>(zw_top),
            static_cast<const T*>(umask), static_cast<const T*>(vmask),
            static_cast<const T*>(on_u),  static_cast<const T*>(om_v),
            static_cast<T*>(ru),          static_cast<T*>(rv),
            N, Mj, Li, T(gsal), T(GRho), T(HalfGRho)};
  prsgrd_kernel<T><<<roms::blocks_for(static_cast<long long>(Mj) * Li),
                     roms::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_PRSGRD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* rho, const void* z_r, const void* Hz,     \
                      const void* zw_top, const void* umask,                \
                      const void* vmask, const void* on_u, const void* om_v, \
                      void* ru, void* rv, int N, int Mj, int Li,            \
                      double gsal, double GRho, double HalfGRho,            \
                      void* stream) {                                       \
    return launch<T>(rho, z_r, Hz, zw_top, umask, vmask, on_u, om_v, ru,    \
                     rv, N, Mj, Li, gsal, GRho, HalfGRho, stream);          \
  }

ROMS_PRSGRD_ENTRY(roms_prsgrd32_f32, float)
ROMS_PRSGRD_ENTRY(roms_prsgrd32_f64, double)
