// Kernel 2: fused tracer advection, UP3 horizontal + C4 vertical, for all
// tracers in one launch, in two modes:
//   predictor: t_half of pre_step3d.F:260-700 (AB2 blend, implied-thickness
//              divide), before bc_rho;
//   corrector: the pre-diffusion Hz*t of step3d_t.F:343-1205.
//
// Replaces roms_tpu/ops/pallas_tadv.py:294 predictor_pallas and :286
// corrector_pallas (both through _call l.195, pallas_call l.268); plain
// versions ops/tadv.py.  Output rows j = 0 and Mj-1 are zeroed, as in the
// Pallas kernel: dead data that bc_rho overwrites.  Closed or EW-periodic
// lanes (the periodic UP3 curvature takes st.periodic_x's lane map instead
// of the wall zeros); NS-periodic grids are refused by the wrapper.
//
// Bound on the H100: bytes.  Each output point needs q, aux (Hz in the
// predictor), Huon, Hvom, W once: ~6-7 words read and 1 written, against
// ~80 flops, far under the flop/byte balance.
//
// Design: one thread per output point (tracer, k, j, i) with i fastest,
// so neighbouring threads read neighbouring addresses.  The face fluxes
// FX(i), FX(i+1), FE(j), FE(j+1) and the C4 interface fluxes are
// recomputed per point from the +-2 stencil; the reuse between
// neighbouring threads comes from L1/L2, not shared memory (a later PR's
// tiling).  Indices wrap like jnp.roll, so the ring lanes hold the same
// values as the reference's whole-array path.
#include "common.cuh"

namespace {

using roms::wrap;

template <typename T>
struct Args {
  const T* q;      // (NT, N, Mj, Li) advected tracer
  const T* aux;    // predictor: t_prev; corrector: t_part (Hz-weighted)
  const T* Huon;   // (N, Mj, Li)
  const T* Hvom;
  const T* Hz;     // predictor only
  const T* W;      // (N+1, Mj, Li)
  const T* pmn;    // (Mj, Li)
  const T* umask;
  const T* vmask;
  T* out;
  int NT, N, Mj, Li;
  int ewp;         // EW-periodic lanes
  T s0, s1, s2;    // predictor: cff, cff1, cff2; corrector: dt
};

template <typename T>
struct Plane {
  const T* q;      // tracer level (Mj*Li)
  const T* hu;     // Huon level
  const T* hv;     // Hvom level
  const T* um;
  const T* vm;
  int Mj, Li;
  bool ewp;

  __device__ T Q(int j, int i) const {
    return q[wrap(j, Mj) * Li + wrap(i, Li)];
  }
  // (q - q(i-1)) * umask at U point (j, i), both in range
  __device__ T dqx(int j, int i) const {
    return (Q(j, i) - Q(j, i - 1)) * um[j * Li + i];
  }
  __device__ T dqe(int j, int i) const {
    return (Q(j, i) - Q(j - 1, i)) * vm[j * Li + i];
  }
  // UP3 curvatures (advection.hadv_flux): zero ring at closed walls,
  // st.periodic_x lanes on an EW-periodic grid
  __device__ T curvx(int j, int i) const {
    if (ewp)
      i = roms::ring_x(i, Li, true);
    else if (i == 0 || i == Li - 1)
      return T(0);
    return dqx(j, i + 1) - dqx(j, i);
  }
  __device__ T curve(int j, int i) const {
    if (j == 0 || j == Mj - 1) return T(0);
    return dqe(j + 1, i) - dqe(j, i);
  }
  __device__ T FX(int j, int i) const {
    i = wrap(i, Li);
    const int im = wrap(i - 1, Li);
    const T h = hu[j * Li + i];
    return h * T(0.5) * (Q(j, i) + Q(j, im)) -
           T(1.0 / 6.0) * (curvx(j, im) * roms::pos(h) +
                           curvx(j, i) * roms::neg(h));
  }
  __device__ T FE(int j, int i) const {
    j = wrap(j, Mj);
    const int jm = wrap(j - 1, Mj);
    const T h = hv[j * Li + i];
    return h * T(0.5) * (Q(j, i) + Q(jm, i)) -
           T(1.0 / 6.0) * (curve(jm, i) * roms::pos(h) +
                           curve(j, i) * roms::neg(h));
  }
};

// C4 vertical flux at interface kk of one column (advection.vadv_flux)
template <typename T>
__device__ __forceinline__ T fc4(const T* q, const T* W, size_t P, int N,
                                 int kk) {
  const T c2 = T(7.0 / 12.0), c3 = T(1.0 / 12.0);
  if (kk == 0 || kk == N) return T(0);
  if (kk == 1)
    return W[P] * (T(0.5) * q[0] + c2 * q[P] - c3 * q[2 * P]);
  if (kk == N - 1)
    return W[(N - 1) * P] * (T(0.5) * q[(N - 1) * P] + c2 * q[(N - 2) * P] -
                             c3 * q[(N - 3) * P]);
  return W[kk * P] * (c2 * (q[(kk - 1) * P] + q[kk * P]) -
                      c3 * (q[(kk - 2) * P] + q[(kk + 1) * P]));
}

template <typename T, bool PREDICTOR>
__global__ void tadv_kernel(Args<T> a) {
  const int Li = a.Li, Mj = a.Mj, N = a.N;
  const size_t P = static_cast<size_t>(Mj) * Li;
  const long long total = static_cast<long long>(a.NT) * N * P;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % Li);
  const int j = static_cast<int>((idx / Li) % Mj);
  const int k = static_cast<int>((idx / P) % N);
  const int itrc = static_cast<int>(idx / (P * N));
  if (j == 0 || j == Mj - 1) {
    a.out[idx] = T(0);
    return;
  }
  const size_t col = static_cast<size_t>(j) * Li + i;
  const T* qcol = a.q + static_cast<size_t>(itrc) * N * P + col;
  Plane<T> pl{qcol - col + k * P, a.Huon + k * P, a.Hvom + k * P, a.umask,
              a.vmask, Mj, Li, a.ewp != 0};
  const T hdiv = (pl.FX(j, i + 1) - pl.FX(j, i)) +
                 (pl.FE(j + 1, i) - pl.FE(j, i));
  const T* Wcol = a.W + col;
  const T vdiv = fc4(qcol, Wcol, P, N, k + 1) - fc4(qcol, Wcol, P, N, k);
  const T pmn = a.pmn[col];
  const size_t o = k * P + col;
  if (PREDICTOR) {
    const T cff = a.s0, cff1 = a.s1, cff2 = a.s2;
    const T Hz = a.Hz[o];
    const T q = qcol[k * P];
    const T qp = a.aux[static_cast<size_t>(itrc) * N * P + o];
    const T th = Hz * (cff1 * q + cff2 * qp) - cff * pmn * hdiv;
    const int ip = wrap(i + 1, Li);
    const size_t row = k * P + static_cast<size_t>(j) * Li;
    const T mass = (a.Huon[row + ip] - a.Huon[row + i]) +
                   (a.Hvom[row + Li + i] - a.Hvom[row + i]) +
                   (Wcol[(k + 1) * P] - Wcol[k * P]);
    const T DC = T(1.0) / (Hz - cff * pmn * mass);
    a.out[idx] = DC * (th - cff * pmn * vdiv);
  } else {
    const T mdt = -a.s0;
    const T tpart = a.aux[idx];
    a.out[idx] = (tpart + mdt * pmn * hdiv) + mdt * pmn * vdiv;
  }
}

template <typename T>
int launch(int predictor, const void* q, const void* aux, const void* Huon,
           const void* Hvom, const void* Hz, const void* W, const void* pmn,
           const void* umask, const void* vmask, void* out, int NT, int N,
           int Mj, int Li, int ewp, double s0, double s1, double s2,
           void* stream) {
  Args<T> a{static_cast<const T*>(q),     static_cast<const T*>(aux),
            static_cast<const T*>(Huon),  static_cast<const T*>(Hvom),
            static_cast<const T*>(Hz),    static_cast<const T*>(W),
            static_cast<const T*>(pmn),   static_cast<const T*>(umask),
            static_cast<const T*>(vmask), static_cast<T*>(out),
            NT, N, Mj, Li, ewp, T(s0), T(s1), T(s2)};
  const long long total = static_cast<long long>(NT) * N * Mj * Li;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (predictor)
    tadv_kernel<T, true><<<roms::blocks_for(total), roms::kThreads, 0, s>>>(a);
  else
    tadv_kernel<T, false><<<roms::blocks_for(total), roms::kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_TADV_ENTRY(NAME, T)                                             \
  extern "C" int NAME(int predictor, const void* q, const void* aux,        \
                      const void* Huon, const void* Hvom, const void* Hz,   \
                      const void* W, const void* pmn, const void* umask,    \
                      const void* vmask, void* out, int NT, int N, int Mj,  \
                      int Li, int ewp, double s0, double s1, double s2,     \
                      void* stream) {                                       \
    return launch<T>(predictor, q, aux, Huon, Hvom, Hz, W, pmn, umask,      \
                     vmask, out, NT, N, Mj, Li, ewp, s0, s1, s2, stream);   \
  }

ROMS_TADV_ENTRY(roms_tadv_f32, float)
ROMS_TADV_ENTRY(roms_tadv_f64, double)
