// Kernel 6: spline implicit vertical diffusion of all tracers
// (step3d_t.F SPLINES_VDIFF): q = pre/Hz, then q + dq from the
// parabolic-spline flux solve.
//
// Replaces roms_tpu/ops/pallas_vdiff.py:37 spline_vdiff_pallas
// (pallas_call l.64; its column solve is pallas_uv.py:59 _spline_dq);
// plain version ops/vdiff.py spline_vdiff_plain over ops/tridiag.py
// spline_flux_solve.  Tracer itrc diffuses with Akt[min(itrc, NAT-1)],
// read in place (no stacked copy).
//
// Bound on the H100: bytes.  Per column and tracer it reads Hz (N), pre
// (N) and Akt (N+1) and writes N values: ~4 words per level against ~25
// flops.
//
// Design: uv_solve's column sweep (uv.cu uv_solve_kernel), one thread per
// (tracer, column), consecutive threads on consecutive columns, the NT
// tracer blocks of one column range next to each other so that they share
// Hz in L2 (block x = b NT + itrc):
//   forward, k = 1 .. N-1: level k's Hz, pre and Akt(k+1) arrive (the next
//     kAhead levels in flight in a ring of registers), q = pre/Hz and
//     1/Hz are formed once, and interface k's Thomas row is eliminated at
//     once: cp, dp;
//   backward, k = N-1 .. 0: back substitution DC(k) and out = q + dq in
//     one pass, Akt(k) read again kAhead levels ahead (from L2), one write
//     a level.
// The state lives in dynamic shared memory laid out [k][thread] and sized
// by N (ops/vdiff.py vdiff_launch_shape): 1/Hz and q (N each), cp and dp
// (N-1 each); no local array, so no stack frame.  Every product that feeds
// an add or subtract is mul_rn and the quotients are IEEE divisions in the
// order of spline_flux_solve, so the kernel is bitwise equal to its plain
// version.
#include "common.cuh"

namespace {

using roms::mul_rn;

// levels the forward sweep keeps in flight ahead of the one it works on
constexpr int kAhead = 4;

template <typename T>
struct VdiffArgs {
  const T *Hz, *Akt, *pre;
  T* out;
  int NT, NAT, N;
  long long P;
  T dt;
};

template <typename T>
__global__ void vdiff_kernel(const __grid_constant__ VdiffArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = blockDim.x, N = a.N, NT = a.NT;
  const size_t P = static_cast<size_t>(a.P);
  const int itrc = static_cast<int>(blockIdx.x % NT);
  const size_t c = static_cast<size_t>(blockIdx.x / NT) * B + threadIdx.x;
  if (c >= P) return;   // no barrier below: each thread owns its slots
  const int iak = itrc < a.NAT - 1 ? itrc : a.NAT - 1;
  const T* hz = a.Hz + c;
  const T* pre = a.pre + static_cast<size_t>(itrc) * N * P + c;
  const T* ak = a.Akt + static_cast<size_t>(iak) * (N + 1) * P + c;
  T* out = a.out + static_cast<size_t>(itrc) * N * P + c;
  T* o_s = reinterpret_cast<T*>(smem) + threadIdx.x;
  T* q_s = o_s + static_cast<size_t>(N) * B;
  T* cp_s = q_s + static_cast<size_t>(N) * B;
  T* dp_s = cp_s + static_cast<size_t>(N - 1) * B;
  const T dt = a.dt, sixth = T(1.0 / 6.0), third = T(1.0 / 3.0);

  // forward: interface k (row k-1) as level k arrives,
  //   FC DC(k-1) + BC DC(k) + CF DC(k+1) = q(k) - q(k-1)
  T hz0 = hz[0];
  T q0 = pre[0] / hz0;
  T o0 = T(1.0) / hz0;
  T ak0 = ak[0], ak1 = ak[P];
  o_s[0] = o0;
  q_s[0] = q0;
  T cpp = T(0), dpp = T(0);
  T rh[kAhead], rp[kAhead], ra[kAhead];
  auto fetch = [&](int k, int u) {
    const size_t o = static_cast<size_t>(k) * P;
    rh[u] = hz[o];
    rp[u] = pre[o];
    ra[u] = ak[o + P];
  };
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (1 + u < N) fetch(1 + u, u);
  for (int k0 = 1; k0 < N; k0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 + u;
      if (k >= N) break;
      const T hz1 = rh[u];
      const T q1 = rp[u] / hz1;
      const T ak2 = ra[u];
      if (k + kAhead < N) fetch(k + kAhead, u);
      const T o1 = T(1.0) / hz1;
      const T FC = mul_rn(sixth, hz0) - mul_rn(mul_rn(dt, ak0), o0);
      const T CF = mul_rn(sixth, hz1) - mul_rn(mul_rn(dt, ak2), o1);
      const T BC =
          mul_rn(third, hz0 + hz1) + mul_rn(mul_rn(dt, ak1), o0 + o1);
      const T denom = T(1.0) / (BC - mul_rn(FC, cpp));
      cpp = mul_rn(CF, denom);
      dpp = mul_rn((q1 - q0) - mul_rn(FC, dpp), denom);
      cp_s[static_cast<size_t>(k - 1) * B] = cpp;
      dp_s[static_cast<size_t>(k - 1) * B] = dpp;
      o_s[static_cast<size_t>(k) * B] = o1;
      q_s[static_cast<size_t>(k) * B] = q1;
      hz0 = hz1;
      q0 = q1;
      o0 = o1;
      ak0 = ak1;
      ak1 = ak2;
    }
  }

  // backward: DC(k) = x(k-1) and out(k) = q(k) + dt/Hz (AK(k+1) DC(k+1) -
  // AK(k) DC(k)), AK(k) read again kAhead levels ahead; ak1 holds AK(N)
  T flux_hi = mul_rn(ak1, T(0));
  T xn = T(0);
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (N - 1 - u >= 0) ra[u] = ak[static_cast<size_t>(N - 1 - u) * P];
  for (int k0 = N - 1; k0 >= 0; k0 -= kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = k0 - u;
      if (k < 0) break;
      const T ak_here = ra[u];
      if (k - kAhead >= 0) ra[u] = ak[static_cast<size_t>(k - kAhead) * P];
      T flux_lo;
      if (k > 0) {
        const size_t m = static_cast<size_t>(k - 1) * B;
        xn = dp_s[m] - mul_rn(cp_s[m], xn);
        flux_lo = mul_rn(ak_here, xn);
      } else {
        flux_lo = mul_rn(ak_here, T(0));
      }
      const size_t s = static_cast<size_t>(k) * B;
      const T dq = mul_rn(mul_rn(dt, o_s[s]), flux_hi - flux_lo);
      out[static_cast<size_t>(k) * P] = q_s[s] + dq;
      flux_hi = flux_lo;
    }
  }
}

template <typename T>
int launch(const VdiffArgs<T>& a, int threads, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(4 * a.N - 2) * threads;
  const cudaError_t err = cudaFuncSetAttribute(
      vdiff_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // this launch's error, not the next one's
    return static_cast<int>(err);
  }
  const long long blocks = a.NT * ((a.P + threads - 1) / threads);
  vdiff_kernel<T><<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ROMS_VDIFF_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* Hz, const void* Akt, const void* pre,     \
                      void* out, int NT, int NAT, int N, int Mj, int Li,    \
                      double dt, int threads, void* stream) {               \
    VdiffArgs<T> a{(const T*)Hz, (const T*)Akt, (const T*)pre, (T*)out,     \
                   NT, NAT, N, (long long)Mj * Li, T(dt)};                  \
    return launch<T>(a, threads, stream);                                    \
  }

ROMS_VDIFF_ENTRY(roms_vdiff_f32, float)
ROMS_VDIFF_ENTRY(roms_vdiff_f64, double)
