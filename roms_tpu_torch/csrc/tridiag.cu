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
// sweep keeps the four loads of the next kAhead levels in flight in a
// ring of registers while level k's dependent division chain runs, and
// keeps cp and dp in dynamic shared memory laid out [k][thread]; the back
// substitution reads them from there and writes each x once.  No local
// array, so no stack frame, and no fixed depth bound: the wrapper sizes
// the block by N and the element size (ops/tridiag.py launch_shape), and
// a launch whose 2 N values a thread do not fit a block's shared memory
// is refused (roms::allow_smem).
#include "common.cuh"

namespace {

using roms::mul_rn;

constexpr int kThreadsTridiag = 256;   // the most threads a block
constexpr int kAhead = 4;   // levels in flight ahead of the one eliminated

template <typename T>
__global__ void __launch_bounds__(kThreadsTridiag)
tridiag_kernel(const T* __restrict__ lower, const T* __restrict__ diag,
               const T* __restrict__ upper, const T* __restrict__ rhs,
               T* __restrict__ out, int N, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = blockDim.x;
  const int c = blockIdx.x * B + threadIdx.x;
  if (c >= P) return;   // no barrier below: each thread owns its slots
  T* cp_s = reinterpret_cast<T*>(smem) + threadIdx.x;
  T* dp_s = cp_s + static_cast<size_t>(N) * B;

  // the raw values of levels k+1 .. k+kAhead are in flight while level k
  // is eliminated (slot u of each unrolled group of kAhead levels)
  T ra[kAhead], rb[kAhead], rc[kAhead], rr[kAhead];
  auto fetch = [&](int k, int u) {
    const size_t at = static_cast<size_t>(k) * P + c;
    ra[u] = lower[at];
    rb[u] = diag[at];
    rc[u] = upper[at];
    rr[u] = rhs[at];
  };
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < N) fetch(u, u);
  T cpp = T(0), dpp = T(0);
  for (int k0 = 0; k0 < N; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= N) break;
      const T a = ra[u], b = rb[u], up = rc[u], r = rr[u];
      if (k + kAhead < N) fetch(k + kAhead, u);
      const T denom = T(1.0) / (b - mul_rn(a, cpp));
      cpp = up * denom;
      dpp = (r - mul_rn(a, dpp)) * denom;
      cp_s[static_cast<size_t>(k) * B] = cpp;
      dp_s[static_cast<size_t>(k) * B] = dpp;
    }
  }
  T x = T(0);
  for (int k = N - 1; k >= 0; --k) {
    const size_t m = static_cast<size_t>(k) * B;
    x = dp_s[m] - mul_rn(cp_s[m], x);
    out[static_cast<size_t>(k) * P + c] = x;
  }
}

template <typename T>
int launch(const void* lower, const void* diag, const void* upper,
           const void* rhs, void* out, int N, int Mj, int Li, int threads,
           void* stream) {
  if (N < 1 || threads < 1 || threads > kThreadsTridiag)
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = Mj * Li;
  const size_t smem = sizeof(T) * 2 * static_cast<size_t>(N) * threads;
  const cudaError_t err = roms::allow_smem(tridiag_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tridiag_kernel<T><<<(P + threads - 1) / threads, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(lower), static_cast<const T*>(diag),
      static_cast<const T*>(upper), static_cast<const T*>(rhs),
      static_cast<T*>(out), N, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_TRIDIAG_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* lower, const void* diag,                   \
                      const void* upper, const void* rhs, void* out, int N,  \
                      int Mj, int Li, int threads, void* stream) {           \
    return launch<T>(lower, diag, upper, rhs, out, N, Mj, Li, threads,       \
                     stream);                                                \
  }

ROMS_TRIDIAG_ENTRY(roms_tridiag_f32, float)
ROMS_TRIDIAG_ENTRY(roms_tridiag_f64, double)
