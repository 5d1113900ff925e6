// Parabolic-spline implicit vertical flux solve of one column, for tracer
// diffusion (vdiff.cu).  The momentum corrector's uv_solve (uv.cu) runs
// the same solve as a streaming sweep with its state in shared memory and
// no stack frame; vdiff is the next to take that sweep.
//
// Translates roms_tpu/ops/pallas_uv.py:59 _spline_dq (used by
// pallas_vdiff.py:27 too), itself ops/tridiag.py spline_flux_solve:
//   FC(k) DC(k-1) + BC(k) DC(k) + CF(k) DC(k+1) = q(k+1) - q(k)
// at interfaces k = 1..N-1 with DC(0) = DC(N) = 0, then
//   q(k) += dt/Hzk(k) * (AK(k) DC(k) - AK(k-1) DC(k-1)).
// The Thomas sweep keeps its coefficients in per-thread local arrays
// sized by the template bound NMAX >= N (checked by the Python wrapper).
#pragma once

#include "common.cuh"

namespace roms {

// q[0..N) is replaced by q + dq; Hzk[0..N), AK[0..N]
template <typename T, int NMAX>
__device__ void spline_dq_inplace(int N, const T* Hzk, const T* AK, T* q,
                                  T dt) {
  T cp[NMAX], dp[NMAX];
  const T sixth = T(1.0 / 6.0), third = T(1.0 / 3.0);
  T cp_prev = T(0), dp_prev = T(0);
  for (int k = 0; k < N - 1; ++k) {
    const T o0 = T(1.0) / Hzk[k];
    const T o1 = T(1.0) / Hzk[k + 1];
    const T lo = sixth * Hzk[k] - dt * AK[k] * o0;
    const T up = sixth * Hzk[k + 1] - dt * AK[k + 2] * o1;
    const T dg = third * (Hzk[k] + Hzk[k + 1]) + dt * AK[k + 1] * (o0 + o1);
    const T denom = T(1.0) / (dg - lo * cp_prev);
    cp[k] = up * denom;
    dp[k] = ((q[k + 1] - q[k]) - lo * dp_prev) * denom;
    cp_prev = cp[k];
    dp_prev = dp[k];
  }
  // back substitution: DC(k+1) for interface k+1 stored in dp[k]
  for (int k = N - 3; k >= 0; --k) dp[k] = dp[k] - cp[k] * dp[k + 1];
  T flux_lo = AK[0] * T(0);
  for (int k = 0; k < N; ++k) {
    const T flux_hi = k < N - 1 ? AK[k + 1] * dp[k] : AK[N] * T(0);
    q[k] = q[k] + dt * (T(1.0) / Hzk[k]) * (flux_hi - flux_lo);
    flux_lo = flux_hi;
  }
}

}  // namespace roms
