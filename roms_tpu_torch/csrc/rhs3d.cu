// Kernel 3: fused 3D momentum right-hand side: Coriolis, curvilinear
// metric terms, UP3 horizontal and C4_SW vertical momentum advection,
// added into ru/rv (rhs3d.F:495-1830).
//
// Replaces roms_tpu/ops/pallas_rhs3d.py:349 rhs3d_momentum_pallas
// (pallas_call l.424); plain version ops/rhs3d.py.  Output rows j = 0 and
// Mj-1 are zeroed, as in the Pallas kernel: dead data that bc_u/bc_v
// overwrite.  Closed or EW-periodic lanes: on a periodic grid the
// curvature arrays, the ringed fluxes and the reach-2 W arm take
// st.periodic_x's lane map (ring_x) where core/rhs3d.py applies it;
// NS-periodic grids are refused by the wrapper.
//
// Bound on the H100: bytes.  Each point reads u, v, Hz, Huon, Hvom, ru, rv
// and W once and writes ru, rv: ~10 words against ~200 flops.
//
// Design: one thread per (k, j, i) point computes both ru and rv, i
// fastest for coalescing.  The UP3 face fluxes and the W averages are
// recomputed from the +-2 stencil per point; neighbour reuse comes from
// L1/L2 (shared-memory tiling is later work).  Shifts wrap like jnp.roll,
// and the closed-wall clamps of the curvature arrays follow
// core/rhs3d.py hadv_uv exactly.
#include "common.cuh"

namespace {

using roms::wrap;

constexpr double GADV = -0.25;

template <typename T>
struct Args {
  const T *u, *v, *Hz, *Huon, *Hvom, *W, *ru, *rv;
  const T *fomn, *dndx, *dmde;
  T *out_u, *out_v;
  int N, Mj, Li;
  int uv_cor, curv, uv_adv, ewp;
};

// one k-level of a field, with jnp.roll-wrapped access
template <typename T>
struct F {
  const T* p;
  int Mj, Li;
  __device__ T operator()(int j, int i) const {
    return p[wrap(j, Mj) * Li + wrap(i, Li)];
  }
  __device__ T lap_x(int j, int i) const {
    return ((*this)(j, i - 1) - T(2.0) * (*this)(j, i)) + (*this)(j, i + 1);
  }
  __device__ T lap_y(int j, int i) const {
    return ((*this)(j - 1, i) - T(2.0) * (*this)(j, i)) + (*this)(j + 1, i);
  }
};

template <typename T>
__device__ __forceinline__ T up3(T cff1, T curv_m, T curv_p, T flux2,
                                 T hyper) {
  const T curv = cff1 > T(0) ? curv_m : curv_p;
  return T(0.25) * (cff1 + T(GADV) * curv) *
         (flux2 + T(GADV * 0.5) * hyper);
}

template <typename T>
struct Level {
  F<T> u, v, hu, hv;
  int Mj, Li;
  bool ewp;

  // lane of a ringed x-array at i in range: periodic map or identity
  __device__ int rx(int i) const { return roms::ring_x(i, Li, ewp); }

  // curvature arrays of core/rhs3d.py hadv_uv, closed-wall clamped or
  // EW-periodic; (j, i) arrive wrapped into range
  __device__ T uxx(int j, int i) const {
    const int ii = ewp ? rx(i) : (i == 1 ? 2 : (i == Li - 1 ? Li - 2 : i));
    return u.lap_x(j, ii);
  }
  __device__ T Huxx(int j, int i) const {
    const int ii = ewp ? rx(i) : (i == 1 ? 2 : (i == Li - 1 ? Li - 2 : i));
    return hu.lap_x(j, ii);
  }
  __device__ T uee(int j, int i) const {
    const int jj = j == 0 ? 1 : (j == Mj - 1 ? Mj - 2 : j);
    return u.lap_y(jj, i);
  }
  __device__ T vxx(int j, int i) const {
    const int ii = ewp ? rx(i) : (i == 0 ? 1 : (i == Li - 1 ? Li - 2 : i));
    return v.lap_x(j, ii);
  }
  __device__ T Hvxx(int j, int i) const {
    return hv.lap_x(j, rx(wrap(i, Li)));
  }
  __device__ T vee(int j, int i) const {
    const int jj = j == 1 ? 2 : (j == Mj - 1 ? Mj - 2 : j);
    return v.lap_y(jj, i);
  }
  __device__ T Hvee(int j, int i) const {
    const int jj = j == 1 ? 2 : (j == Mj - 1 ? Mj - 2 : j);
    return hv.lap_y(jj, i);
  }

  __device__ T UFx(int j, int i) const {
    j = wrap(j, Mj);
    i = rx(wrap(i, Li));
    const int ip = wrap(i + 1, Li);
    return up3(u(j, i) + u(j, ip), uxx(j, i), uxx(j, ip),
               hu(j, i) + hu(j, ip), Huxx(j, i) + Huxx(j, ip));
  }
  __device__ T UFe(int j, int i) const {
    j = wrap(j, Mj);
    i = wrap(i, Li);
    const int jm = wrap(j - 1, Mj);
    const T cff2 = hv(j, i) + hv(j, i - 1);
    const T curv = cff2 > T(0) ? uee(jm, i) : uee(j, i);
    return T(0.25) * (u(j, i) + u(jm, i) + T(GADV) * curv) *
           (cff2 + T(GADV * 0.5) * (Hvxx(j, i) + Hvxx(j, i - 1)));
  }
  __device__ T VFx(int j, int i) const {
    j = wrap(j, Mj);
    i = wrap(i, Li);
    const int im = wrap(i - 1, Li);
    const T cff2 = hu(j, i) + hu(j - 1, i);
    const T curv = cff2 > T(0) ? vxx(j, im) : vxx(j, i);
    return T(0.25) * (v(j, i) + v(j, im) + T(GADV) * curv) *
           (cff2 + T(GADV * 0.5) * (hu.lap_y(j, i) + hu.lap_y(j - 1, i)));
  }
  __device__ T VFe(int j, int i) const {
    j = wrap(j, Mj);
    i = wrap(i, Li);
    const int jp = wrap(j + 1, Mj);
    return up3(v(j, i) + v(jp, i), vee(j, i), vee(jp, i),
               hv(j, i) + hv(jp, i), Hvee(j, i) + Hvee(jp, i));
  }
};

// C4_SW interface flux of one column q (stride P) with the averaged
// W value Wq at interface kk (core/rhs3d.py vadv_uv)
template <typename T>
__device__ __forceinline__ T fc4sw(const T* q, size_t P, int N, int kk,
                                   T Wq) {
  const T c1 = T(9.0 / 16.0), c2 = T(1.0 / 16.0);
  if (kk == 0 || kk == N) return T(0);
  if (kk == 1) return (c1 * (q[0] + q[P]) - c2 * (q[0] + q[2 * P])) * Wq;
  if (kk == N - 1)
    return (c1 * (q[(N - 2) * P] + q[(N - 1) * P]) -
            c2 * (q[(N - 3) * P] + q[(N - 1) * P])) * Wq;
  return (c1 * (q[(kk - 1) * P] + q[kk * P]) -
          c2 * (q[(kk - 2) * P] + q[(kk + 1) * P])) * Wq;
}

template <typename T>
__global__ void rhs3d_kernel(Args<T> a) {
  const int Li = a.Li, Mj = a.Mj, N = a.N;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const long long total = static_cast<long long>(N) * P;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % Li);
  const int j = static_cast<int>((idx / Li) % Mj);
  const int k = static_cast<int>(idx / P);
  if (j == 0 || j == Mj - 1) {
    a.out_u[idx] = T(0);
    a.out_v[idx] = T(0);
    return;
  }
  const size_t lev = static_cast<size_t>(k) * P;
  const F<T> u{a.u + lev, Mj, Li}, v{a.v + lev, Mj, Li};
  const F<T> hz{a.Hz + lev, Mj, Li};
  const F<T> fomn{a.fomn, Mj, Li};
  const bool ewp = a.ewp != 0;
  // lane of a ringed x-array (core/rhs3d.py _ring_x)
  auto rx = [&](int ii) { return roms::ring_x(wrap(ii, Li), Li, ewp); };
  T ru = a.ru[idx];
  T rv = a.rv[idx];

  if (a.uv_cor) {
    // Coriolis (rhs3d.F:502-527)
    auto UFx = [&](int jj, int ii) {
      ii = rx(ii);
      return T(0.5) * hz(jj, ii) * fomn(jj, ii) *
             (v(jj, ii) + v(jj + 1, ii));
    };
    auto VFe = [&](int jj, int ii) {
      ii = rx(ii);
      return T(0.5) * hz(jj, ii) * fomn(jj, ii) *
             (u(jj, ii) + u(jj, ii + 1));
    };
    ru = ru + T(0.5) * (UFx(j, i) + UFx(j, i - 1));
    rv = rv + T(-0.5) * (VFe(j, i) + VFe(j - 1, i));
  }
  if (a.curv && a.uv_adv) {
    // curvilinear metric terms (rhs3d.F:577-660)
    const F<T> dndx{a.dndx, Mj, Li}, dmde{a.dmde, Mj, Li};
    auto terms = [&](int jj, int ii, T& UF, T& VF) {
      ii = rx(ii);
      const T c1 = T(0.5) * (v(jj, ii) + v(jj + 1, ii));
      const T c2 = T(0.5) * (u(jj, ii) + u(jj, ii + 1));
      const T cff = hz(jj, ii) * (c1 * dndx(jj, ii) - c2 * dmde(jj, ii));
      UF = cff * c1;
      VF = cff * c2;
    };
    T UF0, VF0, UFm, VFm, UFj, VFj;
    terms(j, i, UF0, VF0);
    terms(j, i - 1, UFm, VFm);
    terms(j - 1, i, UFj, VFj);
    ru = ru + T(0.5) * (UF0 + UFm);
    rv = rv + T(-0.5) * (VF0 + VFj);
  }
  if (a.uv_adv) {
    // UP3 horizontal advection (rhs3d.F:668-1010)
    const Level<T> L{u, v, F<T>{a.Huon + lev, Mj, Li},
                     F<T>{a.Hvom + lev, Mj, Li}, Mj, Li, ewp};
    const T hu = -(L.UFx(j, i) - L.UFx(j, i - 1)) -
                 (L.UFe(j + 1, i) - L.UFe(j, i));
    const T hv = -(L.VFx(j, i + 1) - L.VFx(j, i)) -
                 (L.VFe(j, i) - L.VFe(j - 1, i));
    ru = ru + hu;
    rv = rv + hv;

    // C4_SW vertical advection with 4th-order W averages
    // (rhs3d.F:1133-1168); on a periodic grid W is ringed and the
    // reach-2 arm Wm = periodic_x(im1(W)) is ringed again
    const T c1 = T(9.0 / 16.0), c2 = T(1.0 / 16.0);
    auto Wu = [&](int kk) {
      const F<T> w{a.W + static_cast<size_t>(kk) * P, Mj, Li};
      auto wp = [&](int ii) { return w(j, rx(ii)); };
      auto wm = [&](int ii) { return wp(rx(ii) - 1); };
      return c1 * (wp(i) + wm(i)) - c2 * (wp(i + 1) + wm(i - 1));
    };
    auto Wv = [&](int kk) {
      const F<T> w{a.W + static_cast<size_t>(kk) * P, Mj, Li};
      const int ii = rx(i);
      return c1 * (w(j, ii) + w(j - 1, ii)) -
             c2 * (w(j + 1, ii) + w(j - 2, ii));
    };
    const size_t col = static_cast<size_t>(j) * Li + i;
    const T* uc = a.u + col;
    const T* vc = a.v + col;
    const T fu1 = (k + 1 == N) ? T(0) : fc4sw(uc, P, N, k + 1, Wu(k + 1));
    const T fu0 = (k == 0) ? T(0) : fc4sw(uc, P, N, k, Wu(k));
    const T fv1 = (k + 1 == N) ? T(0) : fc4sw(vc, P, N, k + 1, Wv(k + 1));
    const T fv0 = (k == 0) ? T(0) : fc4sw(vc, P, N, k, Wv(k));
    ru = ru + -(fu1 - fu0);
    rv = rv + -(fv1 - fv0);
  }
  a.out_u[idx] = ru;
  a.out_v[idx] = rv;
}

template <typename T>
int launch(const void* u, const void* v, const void* Hz, const void* Huon,
           const void* Hvom, const void* W, const void* ru, const void* rv,
           const void* fomn, const void* dndx, const void* dmde, void* out_u,
           void* out_v, int N, int Mj, int Li, int uv_cor, int curv,
           int uv_adv, int ewp, void* stream) {
  Args<T> a{static_cast<const T*>(u),    static_cast<const T*>(v),
            static_cast<const T*>(Hz),   static_cast<const T*>(Huon),
            static_cast<const T*>(Hvom), static_cast<const T*>(W),
            static_cast<const T*>(ru),   static_cast<const T*>(rv),
            static_cast<const T*>(fomn), static_cast<const T*>(dndx),
            static_cast<const T*>(dmde), static_cast<T*>(out_u),
            static_cast<T*>(out_v),      N, Mj, Li, uv_cor, curv, uv_adv,
            ewp};
  const long long total = static_cast<long long>(N) * Mj * Li;
  rhs3d_kernel<T><<<roms::blocks_for(total), roms::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_RHS3D_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* u, const void* v, const void* Hz,         \
                      const void* Huon, const void* Hvom, const void* W,    \
                      const void* ru, const void* rv, const void* fomn,     \
                      const void* dndx, const void* dmde, void* out_u,      \
                      void* out_v, int N, int Mj, int Li, int uv_cor,       \
                      int curv, int uv_adv, int ewp, void* stream) {        \
    return launch<T>(u, v, Hz, Huon, Hvom, W, ru, rv, fomn, dndx, dmde,     \
                     out_u, out_v, N, Mj, Li, uv_cor, curv, uv_adv, ewp,    \
                     stream);                                               \
  }

ROMS_RHS3D_ENTRY(roms_rhs3d_f32, float)
ROMS_RHS3D_ENTRY(roms_rhs3d_f64, double)
