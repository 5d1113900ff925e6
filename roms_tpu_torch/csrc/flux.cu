// Kernels 7 and 8: horizontal mass fluxes fused with the vertical mass flux
// (set_massflux.F:140-163 + omega.F:200-345), two entry points in one
// kernel:
//   flux_omega: Huon = Hz_u*u*on_u, Hvom = Hz_v*v*om_v with the EW ring
//               refresh, then W from them;
//   omega:      W alone from given Huon/Hvom (the corrector site).
// W[k] = -sum_{m<k} div[m] bottom-up, the drift correction that makes
// W[N] vanish, W[N] = 0, then bc_rho (ring rows copy their inner
// neighbour, lanes 0 and Li-1 the periodic ones).
//
// Replaces roms_tpu/ops/pallas_flux.py:152 flux_omega_pallas (pallas_call
// l.170) and :185 omega_pallas (l.198); plain versions ops/flux.py.  The
// class is the kernel's: EW-periodic, not NS-periodic, closed or gradient
// N/S zeta walls.  Every point carries the plain path's value: Huon/Hvom
// ring rows hold set_massflux's jnp.roll wrap (the Pallas kernel leaves
// other dead values there), so kernel and plain version compare whole.
//
// Bound on the H100: bytes.  flux_omega reads u, v, Hz (N levels), z_w
// (N+1), on_u, om_v and writes Huon, Hvom (N) and W (N+1); omega reads
// Huon, Hvom, z_w and writes W.  ~15 flops a level.
//
// Design: one thread per (j, i) column walking k, consecutive threads on
// consecutive i.  The column whose W lands at (j, i) is the bc_rho source
// (rm(j), ring_x(i)), so ring threads need no second pass.  The drift
// correction needs the column total first: the thread sums div over k,
// then walks k again in the same order to write W (the recomputed fluxes
// come from L1/L2).  Products that feed a subtraction are mul_rn, so each
// value rounds as in the plain version.
#include "common.cuh"

namespace {

using roms::mul_rn;
using roms::wrap;

template <typename T>
struct Args {
  const T *u, *v, *Hz, *on_u, *om_v;  // flux_omega inputs
  const T* z_w;                       // (N+1, Mj, Li)
  T *Huon, *Hvom;   // flux_omega: outputs; omega: inputs
  T* W;             // (N+1, Mj, Li)
  int N, Mj, Li;
};

template <typename T, bool FLUX>
struct Fluxes {
  const Args<T>& a;
  size_t P;

  // Huon of level k at (j, i) in range, as st.periodic_x leaves it
  __device__ T hu(int k, int j, int i) const {
    if (!FLUX) return a.Huon[k * P + static_cast<size_t>(j) * a.Li + i];
    i = roms::ring_x(i, a.Li, true);
    const size_t r = static_cast<size_t>(j) * a.Li;
    const size_t l = k * P + r;
    const T hzu = T(0.5) * (a.Hz[l + i] + a.Hz[l + wrap(i - 1, a.Li)]);
    return mul_rn(hzu * a.u[l + i], a.on_u[r + i]);
  }
  __device__ T hv(int k, int j, int i) const {
    if (!FLUX) return a.Hvom[k * P + static_cast<size_t>(j) * a.Li + i];
    i = roms::ring_x(i, a.Li, true);
    const size_t r = static_cast<size_t>(j) * a.Li + i;
    const size_t rm = static_cast<size_t>(wrap(j - 1, a.Mj)) * a.Li + i;
    const T hzv = T(0.5) * (a.Hz[k * P + r] + a.Hz[k * P + rm]);
    return mul_rn(hzv * a.v[k * P + r], a.om_v[r]);
  }
  // (ip1(Huon) - Huon) + (jp1(Hvom) - Hvom) at level k
  __device__ T div(int k, int j, int i) const {
    return (hu(k, j, wrap(i + 1, a.Li)) - hu(k, j, i)) +
           (hv(k, wrap(j + 1, a.Mj), i) - hv(k, j, i));
  }
};

template <typename T, bool FLUX>
__global__ void flux_omega_kernel(Args<T> a) {
  const int Li = a.Li, Mj = a.Mj, N = a.N;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Mj * Li) return;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const int i = c % Li, j = c / Li;
  const Fluxes<T, FLUX> fx{a, P};
  if (FLUX) {
    for (int k = 0; k < N; ++k) {
      a.Huon[k * P + c] = fx.hu(k, j, i);
      a.Hvom[k * P + c] = fx.hv(k, j, i);
    }
  }
  // W of the bc_rho source column
  const int wj = j == 0 ? 1 : (j == Mj - 1 ? Mj - 2 : j);
  const int wi = roms::ring_x(i, Li, true);
  const size_t wc = static_cast<size_t>(wj) * Li + wi;
  T acc = T(0);
  for (int k = 0; k < N; ++k) acc = acc + fx.div(k, wj, wi);
  const T zw0 = a.z_w[wc];
  const T wrk = -acc / (a.z_w[N * P + wc] - zw0);
  a.W[c] = T(0) - mul_rn(wrk, zw0 - zw0);
  acc = T(0);
  for (int k = 0; k < N - 1; ++k) {
    acc = acc + fx.div(k, wj, wi);
    a.W[(k + 1) * P + c] = -acc - mul_rn(wrk, a.z_w[(k + 1) * P + wc] - zw0);
  }
  a.W[N * P + c] = T(0);
}

template <typename T>
int launch(int with_flux, const void* u, const void* v, const void* Hz,
           const void* on_u, const void* om_v, const void* z_w, void* Huon,
           void* Hvom, void* W, int N, int Mj, int Li, void* stream) {
  Args<T> a{static_cast<const T*>(u),    static_cast<const T*>(v),
            static_cast<const T*>(Hz),   static_cast<const T*>(on_u),
            static_cast<const T*>(om_v), static_cast<const T*>(z_w),
            static_cast<T*>(Huon),       static_cast<T*>(Hvom),
            static_cast<T*>(W),          N, Mj, Li};
  const int nb = roms::blocks_for(static_cast<long long>(Mj) * Li);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_flux)
    flux_omega_kernel<T, true><<<nb, roms::kThreads, 0, s>>>(a);
  else
    flux_omega_kernel<T, false><<<nb, roms::kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_FLUX_ENTRY(NAME, T)                                             \
  extern "C" int NAME(int with_flux, const void* u, const void* v,          \
                      const void* Hz, const void* on_u, const void* om_v,   \
                      const void* z_w, void* Huon, void* Hvom, void* W,     \
                      int N, int Mj, int Li, void* stream) {                \
    return launch<T>(with_flux, u, v, Hz, on_u, om_v, z_w, Huon, Hvom, W,   \
                     N, Mj, Li, stream);                                    \
  }

ROMS_FLUX_ENTRY(roms_flux_omega_f32, float)
ROMS_FLUX_ENTRY(roms_flux_omega_f64, double)
