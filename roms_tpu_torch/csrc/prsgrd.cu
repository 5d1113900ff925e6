// Kernel 9 (PERF.md's table): baroclinic pressure gradient, splines
// density Jacobian (prsgrd32.h:158-378, Shchepetkin & McWilliams 2003):
// vertical spline derivatives with harmonic-mean limiting, the top-down
// pressure integral and both horizontal density Jacobians, into ru/rv.
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
// Design: one 256-thread block per tile of TJ x TI columns (ops/prsgrd.py
// launch_shape; 7 x 31), marching k from N-1 down to 0.  A thread owns one
// column of the tile grown by the west lane and the south row its
// Jacobians reach ((TJ+1) x (TI+1) columns), so each column's pressure is
// integrated once a level by one thread of the block: it carries rho and
// z_r at k-1 .. k+1 (level k-2 loaded a level ahead), the spline means
// dRm/dZm of the level above (each formed once), P_top and the running sum
// in registers, and writes P(k) to shared memory.  Each level is two
// barrier-separated phases:
//   A. (issued first, completed two levels on) cp.async copies of level
//      k-2's rho and z_r on a window of the tile with two rows and lanes
//      south/west and one north/east (the reach of the limited
//      differences), into the third of three shared-memory buffers (the
//      masks are staged once); each thread's P(k) and Hz(k); the harmonic
//      means at its U point (dRx, dZx, through the periodic ring twice) and
//      its V point (dRe, dZe), each once, from the masked differences
//      formed from the window (so each of those is formed twice: a phase
//      that formed each once, between its own barriers, was slower on the
//      H100);
//   B. each tile point's Jacobians from shared memory: the west and south
//      neighbours' pressure, rho, z_r, Hz and limited differences.
// The sums run in the order of the plain version's flipped cumsum on the
// card: the increments accumulate among themselves top-down, and P_top is
// added per level.
//
// Lanes and rows: the window wraps as jnp.roll wraps (rows mod Mj, lanes
// mod Li).  The periodic ring of ax and of the harmonic means (lane 0 <-
// Li-2, Li-1 <- 1, st.periodic_x) is two tables of the window: the position
// of the ringed lane's first copy that has a west neighbour (for ax) or
// neighbours both sides (for the means).  Tiles whose tables are the identity (all but
// the seam's) run a copy of the level loop that reads no table.  The lane
// tiling is shifted half a tile, so that lanes Li-3 .. 2 lie in the seam's
// tile.  (Checked with the CUDA source compiled for the CPU, shared memory
// poisoned with NaN: bitwise at every tiling tried.)
//
// The density Jacobian subtracts nearly equal pressures, so every product
// that feeds an add or subtract is mul_rn: each value rounds as in the
// plain version.
#include <type_traits>

#include "common.cuh"

namespace {

using roms::copy_async;
using roms::copy_commit;
using roms::copy_wait;
using roms::mul_rn;

constexpr double kEps = 1.0e-10;
constexpr double kFifth = 0.2;
constexpr double kTwelfth = 1.0 / 12.0;
constexpr int kThreadsPrs = 256;
constexpr int kHaloLo = 2;   // window rows south and lanes west of the tile
constexpr int kHaloHi = 1;   // window rows north and lanes east of the tile
constexpr int kStages = 3;   // level buffers: levels k-1 and k-2 in flight

template <typename T>
struct Params {
  const T *rho, *z_r, *Hz;   // (N, Mj, Li)
  const T* zw_top;           // z_w[N] (Mj, Li)
  const T *umask, *vmask, *on_u, *om_v;
  T *ru, *rv;
  int N, Mj, Li, TJ, TI;
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

// the block's shared arrays (ops/prsgrd.py launch_shape counts the bytes)
template <typename T>
struct Smem {
  int WJ, WI, WP;
  T* raw;                   // kStages buffers x (rho, z_r) window planes
  T *um, *vm;               // the masks
  T *dRx, *dZx, *dRe, *dZe; // harmonic means of the masked differences
  T *P, *hz;                // pressure and Hz of the level
  int *rowg, *colg, *ta, *td;
  int* goff;                // each window position's offset in a plane

  __device__ void carve(void* base, int TJ, int TI) {
    WJ = TJ + kHaloLo + kHaloHi;
    WI = TI + kHaloLo + kHaloHi;
    WP = WJ * WI;
    raw = static_cast<T*>(base);
    T* f = raw + 2 * kStages * WP;
    T** planes[] = {&um, &vm, &dRx, &dZx, &dRe, &dZe, &P, &hz};
    for (T** pl : planes) {
      *pl = f;
      f += WP;
    }
    rowg = reinterpret_cast<int*>(f);
    colg = rowg + WJ;
    ta = colg + WI;
    td = ta + WI;
    goff = td + WI;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreadsPrs)
prsgrd_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<T> s;
  s.carve(smem, p.TJ, p.TI);
  const int N = p.N, Mj = p.Mj, Li = p.Li;
  const int WI = s.WI;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const T HalfGRho = p.HalfGRho;
  // the block's tile (lane tiling shifted by half a tile: the periodic
  // seam lies in tile 0)
  const roms::Tile t(p.TJ, p.TI, Mj, Li);
  const int tj = t.tj, ti = t.ti;
  const int wi = ti + kHaloLo + kHaloHi;

  // tables: global row and lane of each window position; where the ringed
  // ax (ta, a position with a west neighbour) and the ringed means (td, a
  // position with neighbours both sides) take their values
  __shared__ int mapped;
  if (threadIdx.x == 0) mapped = 0;
  t.tables(kHaloLo, s.WJ, WI, Mj, Li, s.rowg, s.colg);
  __syncthreads();
  for (int n = threadIdx.x; n < WI; n += blockDim.x) {
    const int g = s.colg[n];
    const int h = roms::ring_x(g, Li, true);
    int a = n, d = n;
    if (h != g) {
      a = min(1 + roms::mod(h - s.colg[1], Li), wi - 1);
      d = min(1 + roms::mod(h - s.colg[1], Li), wi - 2);
      mapped = 1;
    }
    s.ta[n] = a;
    s.td[n] = d;
  }
  for (int n = threadIdx.x; n < s.WP; n += blockDim.x) {
    const int r = n / WI, c = n - r * WI;
    const int g = s.rowg[r] * Li + s.colg[c];
    s.goff[n] = g;
    s.um[n] = p.umask[g];
    s.vm[n] = p.vmask[g];
  }

  // this thread's column (y, x) of the grown tile, y in [-1, tj), x in
  // [-1, ti): its window position and global offset
  const int gw = ti + 1;
  const bool act = static_cast<int>(threadIdx.x) < (tj + 1) * gw;
  const int yy = act ? threadIdx.x / gw : 1;
  const int xx = act ? threadIdx.x - yy * gw : 1;
  const int y = yy - 1, x = xx - 1;
  const bool tile = act && y >= 0 && x >= 0;
  const int pw = (y + kHaloLo) * WI + x + kHaloLo;
  __syncthreads();
  const size_t gofs =
      static_cast<size_t>(s.rowg[y + kHaloLo]) * Li + s.colg[x + kHaloLo];

  // the column's state: rho and z_r at k+1 (r1, z1), k (r0, z0) and k-1
  // (rm, zm, loaded a level ahead), dRi(k) (the difference above, di_r),
  // the means dRm/dZm at k+1, P_top and the running sum
  T r1 = T(0), z1 = T(0), r0 = T(0), z0 = T(0), rm = T(0), zm = T(0);
  T di_r = T(0), di_z = T(0), Rm1 = T(0), Zm1 = T(0), Ptop = T(0),
    acc = T(0), hzn = T(0);
  T cu = T(0), cv = T(0);
  if (act) {
    const size_t top = static_cast<size_t>(N - 1) * P + gofs;
    r0 = p.rho[top];
    z0 = p.z_r[top];
    rm = p.rho[top - P];
    zm = p.z_r[top - P];
    hzn = p.Hz[top];
    const T zw = p.zw_top[gofs];
    const T cff1 = T(1.0) / (z0 - zm);
    const T cff2 = mul_rn(T(0.5) * (r0 - rm) * (zw - z0), cff1);
    Ptop = mul_rn(p.gsal, zw) + mul_rn(p.GRho * (r0 + cff2), zw - z0);
    if (tile) {
      cu = T(0.5) * p.on_u[gofs];
      cv = T(0.5) * p.om_v[gofs];
    }
  }

  // stage level kk into raw buffer b
  auto stage = [&](int kk, int b) {
    T* dst = s.raw + 2 * b * s.WP;
    const size_t lev = static_cast<size_t>(kk) * P;
    for (int n = threadIdx.x; n < s.WP; n += blockDim.x) {
      const size_t g = lev + s.goff[n];
      copy_async(dst + n, p.rho + g);
      copy_async(dst + s.WP + n, p.z_r + g);
    }
  };
  for (int b = 0; b < kStages - 1; ++b) {
    if (N - 1 - b >= 0) stage(N - 1 - b, (N - 1 - b) % kStages);
    copy_commit();
  }
  copy_wait<kStages - 2>();

  auto march = [&](auto map) {
    constexpr bool MAP = decltype(map)::value;
    for (int k = N - 1; k >= 0; --k) {
      const size_t lev = static_cast<size_t>(k) * P;
      __syncthreads();
      // A. level k-kStages+1 is copied into the buffer of level k+1 while
      // level k is used
      const int kn = k - kStages + 1;
      if (kn >= 0) stage(kn, kn % kStages);
      copy_commit();
      const T* sr = s.raw + 2 * (k % kStages) * s.WP;
      const T* sz = sr + s.WP;
      if (act) {
        // the column's pressure at level k (core/prsgrd.py dP, P)
        T rl = T(0), zl = T(0);
        if (k >= 2) {
          rl = p.rho[lev - 2 * P + gofs];
          zl = p.z_r[lev - 2 * P + gofs];
        }
        // dRi(k-1) = rho(k) - rho(k-1), clamped to dRi(0) at k = 0; at the
        // top dRi(k) is clamped to dRi(N-2)
        const T lo_r = k >= 1 ? r0 - rm : di_r;
        const T lo_z = k >= 1 ? z0 - zm : di_z;
        const T hi_r = k == N - 1 ? lo_r : di_r;
        const T hi_z = k == N - 1 ? lo_z : di_z;
        const T Rm0 = harmonic(hi_r, lo_r);
        const T Zm0 = harmonic_z(hi_z, lo_z);
        T Pk = Ptop;
        if (k < N - 1) {
          const T dz = z1 - z0;
          const T X = mul_rn(Rm1 - Rm0, dz - mul_rn(T(kTwelfth), Zm1 + Zm0)) -
                      mul_rn(Zm1 - Zm0,
                             r1 - r0 - mul_rn(T(kTwelfth), Rm1 + Rm0));
          const T dP = mul_rn(HalfGRho, mul_rn(r1 + r0, dz) -
                                            mul_rn(T(kFifth), X));
          acc = k == N - 2 ? dP : acc + dP;
          Pk = Ptop + acc;
        }
        s.P[pw] = Pk;
        s.hz[pw] = hzn;
        if (k >= 1) hzn = p.Hz[lev - P + gofs];
        di_r = lo_r;
        di_z = lo_z;
        Rm1 = Rm0;
        Zm1 = Zm0;
        r1 = r0;
        z1 = z0;
        r0 = rm;
        z0 = zm;
        rm = rl;
        zm = zl;
      }
      // the limited differences at this thread's U and V points
      if (act) {
        // the masked differences (f - im1 f)*umask and (f - jm1 f)*vmask
        auto ax = [&](const T* f, int w) {
          return mul_rn(f[w] - f[w - 1], s.um[w]);
        };
        auto ay = [&](const T* f, int w) {
          return mul_rn(f[w] - f[w - WI], s.vm[w]);
        };
        if (y >= 0) {
          const int row = pw - x - kHaloLo;
          const int m = MAP ? s.td[x + kHaloLo] : x + kHaloLo;
          const int a0 = MAP ? s.ta[m] : m, a1 = MAP ? s.ta[m + 1] : m + 1;
          s.dRx[pw] = harmonic(ax(sr, row + a0), ax(sr, row + a1));
          s.dZx[pw] = harmonic(ax(sz, row + a0), ax(sz, row + a1));
        }
        if (x >= 0) {
          s.dRe[pw] = harmonic(ay(sr, pw), ay(sr, pw + WI));
          s.dZe[pw] = harmonic(ay(sz, pw), ay(sz, pw + WI));
        }
      }
      __syncthreads();
      // B. the Jacobians of this thread's tile point
      if (tile) {
        const int w = pw, ws = pw - WI;
        const T gu = jacobian(s.P[w - 1], s.P[w], sr[w], sr[w - 1], sz[w],
                              sz[w - 1], s.dRx[w], s.dRx[w - 1], s.dZx[w],
                              s.dZx[w - 1], HalfGRho);
        p.ru[lev + gofs] = cu * (s.hz[w] + s.hz[w - 1]) * gu;
        const T gv = jacobian(s.P[ws], s.P[w], sr[w], sr[ws], sz[w], sz[ws],
                              s.dRe[w], s.dRe[ws], s.dZe[w], s.dZe[ws],
                              HalfGRho);
        p.rv[lev + gofs] = cv * (s.hz[w] + s.hz[ws]) * gv;
      }
      copy_wait<kStages - 2>();
    }
  };
  if (mapped)
    march(std::true_type{});
  else
    march(std::false_type{});
}

template <typename T>
int launch(const void* const* in, void* ru, void* rv, int N, int Mj, int Li,
           int TJ, int TI, double gsal, double GRho, double HalfGRho,
           void* stream) {
  Params<T> p;
  const T** fields[] = {&p.rho,   &p.z_r,   &p.Hz,   &p.zw_top,
                        &p.umask, &p.vmask, &p.on_u, &p.om_v};
  for (int n = 0; n < 8; ++n) *fields[n] = static_cast<const T*>(in[n]);
  p.ru = static_cast<T*>(ru);
  p.rv = static_cast<T*>(rv);
  p.N = N;
  p.Mj = Mj;
  p.Li = Li;
  p.TJ = TJ;
  p.TI = TI;
  p.gsal = T(gsal);
  p.GRho = T(GRho);
  p.HalfGRho = T(HalfGRho);
  const size_t WJ = TJ + kHaloLo + kHaloHi, WI = TI + kHaloLo + kHaloHi;
  const size_t smem = sizeof(T) * (2 * kStages + 8) * WJ * WI +
                      sizeof(int) * (WJ + 3 * WI + WJ * WI);
  if ((TJ + 1) * (TI + 1) > kThreadsPrs || N < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      prsgrd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }
  const dim3 grid((Li + TI - 1) / TI, (Mj + TJ - 1) / TJ);
  prsgrd_kernel<T><<<grid, kThreadsPrs, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_PRSGRD_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* rho, const void* z_r, const void* Hz,     \
                      const void* zw_top, const void* umask,                \
                      const void* vmask, const void* on_u, const void* om_v, \
                      void* ru, void* rv, int N, int Mj, int Li, int TJ,    \
                      int TI, double gsal, double GRho, double HalfGRho,    \
                      void* stream) {                                       \
    const void* in[8] = {rho, z_r, Hz, zw_top, umask, vmask, on_u, om_v};   \
    return launch<T>(in, ru, rv, N, Mj, Li, TJ, TI, gsal, GRho, HalfGRho,   \
                     stream);                                               \
  }

ROMS_PRSGRD_ENTRY(roms_prsgrd32_f32, float)
ROMS_PRSGRD_ENTRY(roms_prsgrd32_f64, double)
