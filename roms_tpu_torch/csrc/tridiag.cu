// Kernel 17: batched tridiagonal solves along k (Thomas algorithm),
// lower[k] x[k-1] + diag[k] x[k] + upper[k] x[k+1] = rhs[k] with
// lower[0] and upper[N-1] ignored; the implicit TKE/psi and spline
// shear solves of the GLS and MY2.5 closures.
//
// Replaces roms_tpu/ops/pallas_tridiag.py:60 tridiag_solve_pallas
// (pallas_call l.104, _thomas_kernel l.33-57); plain version
// ops/tridiag.py tridiag_plain, with the same association:
// denom = 1/(diag - lower*cp), cp = upper*denom,
// dp = (rhs - lower*dp)*denom, x = dp - cp*x_next.  Every product that
// feeds a subtraction is mul_rn, so nvcc contracts none into an FMA and
// the kernel rounds as the plain version does; 1/x is IEEE division.
//
// Bound on the H100: bytes.  Each column reads four inputs and writes
// one output of N values against ~8 flops a level.
//
// Design: one thread per (j, i) column, i fastest, so every level's
// loads and stores are coalesced (levels lie Mj*Li apart).  The forward
// sweep writes dp straight into the output and keeps cp in a per-thread
// array bounded by kNmax = 128, roms_tpu's own depth bound for the
// kernel (ops/tridiag.py NMAX); the array lives in local memory, which
// the back substitution reads again from L1/L2.
#include "common.cuh"

namespace {

constexpr int kTridiagNmax = 128;

template <typename T>
__global__ void tridiag_kernel(const T* __restrict__ lower,
                               const T* __restrict__ diag,
                               const T* __restrict__ upper,
                               const T* __restrict__ rhs,
                               T* __restrict__ out, int N, int P) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P) return;
  T cp[kTridiagNmax];
  T cp_prev = T(0), dp_prev = T(0);
  for (int k = 0; k < N; ++k) {
    const size_t at = static_cast<size_t>(k) * P + c;
    const T a = lower[at];
    const T denom = T(1.0) / (diag[at] - roms::mul_rn(a, cp_prev));
    cp_prev = upper[at] * denom;
    dp_prev = (rhs[at] - roms::mul_rn(a, dp_prev)) * denom;
    cp[k] = cp_prev;
    out[at] = dp_prev;
  }
  T x_next = T(0);
  for (int k = N - 1; k >= 0; --k) {
    const size_t at = static_cast<size_t>(k) * P + c;
    x_next = out[at] - roms::mul_rn(cp[k], x_next);
    out[at] = x_next;
  }
}

}  // namespace

#define ROMS_TRIDIAG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* lower, const void* diag,                   \
                      const void* upper, const void* rhs, void* out, int N,  \
                      int Mj, int Li, void* stream) {                        \
    if (N < 1 || N > kTridiagNmax) return (int)cudaErrorInvalidValue;        \
    const int P = Mj * Li;                                                   \
    tridiag_kernel<T><<<roms::blocks_for(P), roms::kThreads, 0,              \
                        (cudaStream_t)stream>>>(                             \
        (const T*)lower, (const T*)diag, (const T*)upper, (const T*)rhs,     \
        (T*)out, N, P);                                                      \
    return (int)cudaGetLastError();                                          \
  }

ROMS_TRIDIAG_ENTRY(roms_tridiag_f32, float)
ROMS_TRIDIAG_ENTRY(roms_tridiag_f64, double)
