// Kernel 5: spline implicit vertical diffusion of all tracers
// (step3d_t.F SPLINES_VDIFF): q = pre/Hz, then q + dq from the
// parabolic-spline flux solve (spline_dq.cuh).
//
// Replaces roms_tpu/ops/pallas_vdiff.py:37 spline_vdiff_pallas
// (pallas_call l.64); plain version ops/vdiff.py.  Tracer itrc diffuses
// with Akt[min(itrc, NAT-1)], read in place (no stacked copy).
//
// Bound on the H100: bytes.  Per column it reads Hz (N), pre (N) and
// Akt (N+1) and writes N values: ~4 words per level against ~20 flops.
//
// Design: one thread per (tracer, j, i) column, i fastest for coalesced
// k-plane access; the column lives in per-thread local arrays (bound
// kNmax).
#include "common.cuh"
#include "spline_dq.cuh"

namespace {

using roms::kNmax;

template <typename T>
__global__ void vdiff_kernel(const T* __restrict__ Hz,
                             const T* __restrict__ Akt,
                             const T* __restrict__ pre, T* __restrict__ out,
                             int NT, int NAT, int N, int P, T dt) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(NT) * P) return;
  const int c = static_cast<int>(idx % P);
  const int itrc = static_cast<int>(idx / P);
  const int iak = itrc < NAT - 1 ? itrc : NAT - 1;
  const size_t tbase = static_cast<size_t>(itrc) * N * P + c;
  const size_t abase = static_cast<size_t>(iak) * (N + 1) * P + c;
  T hz[kNmax], ak[kNmax + 1], q[kNmax];
  for (int k = 0; k < N; ++k) {
    hz[k] = Hz[static_cast<size_t>(k) * P + c];
    q[k] = pre[tbase + static_cast<size_t>(k) * P] / hz[k];
  }
  for (int k = 0; k <= N; ++k) ak[k] = Akt[abase + static_cast<size_t>(k) * P];
  roms::spline_dq_inplace<T, kNmax>(N, hz, ak, q, dt);
  for (int k = 0; k < N; ++k) out[tbase + static_cast<size_t>(k) * P] = q[k];
}

}  // namespace

#define ROMS_VDIFF_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* Hz, const void* Akt, const void* pre,     \
                      void* out, int NT, int NAT, int N, int Mj, int Li,    \
                      double dt, void* stream) {                            \
    const int P = Mj * Li;                                                   \
    vdiff_kernel<T><<<roms::blocks_for((long long)NT * P), roms::kThreads,  \
                      0, (cudaStream_t)stream>>>(                           \
        (const T*)Hz, (const T*)Akt, (const T*)pre, (T*)out, NT, NAT, N, P, \
        T(dt));                                                              \
    return (int)cudaGetLastError();                                          \
  }

ROMS_VDIFF_ENTRY(roms_vdiff_f32, float)
ROMS_VDIFF_ENTRY(roms_vdiff_f64, double)
