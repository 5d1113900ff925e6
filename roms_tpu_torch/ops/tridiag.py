"""Batched tridiagonal solves along k (port of roms_tpu/ops/tridiag.py).

Plain PyTorch Thomas sweeps over whole horizontal planes, arrays
[k, ...] with k axis 0.  These are the plain versions behind the
spline solves of kernels 4 and 5 (ops/uv.py, ops/vdiff.py; the shared
CUDA sweep is csrc/spline_dq.cuh).
"""

from __future__ import annotations

import torch


def tridiag_solve(lower, diag, upper, rhs):
    """Thomas algorithm along axis 0: lower[k] multiplies x[k-1]
    (lower[0] ignored), upper[k] multiplies x[k+1] (upper[-1]
    ignored)."""
    n = rhs.shape[0]
    cp = torch.empty_like(rhs)
    dp = torch.empty_like(rhs)
    cp_prev = torch.zeros_like(rhs[0])
    dp_prev = torch.zeros_like(rhs[0])
    for k in range(n):
        denom = 1.0 / (diag[k] - lower[k] * cp_prev)
        cp[k] = upper[k] * denom
        dp[k] = (rhs[k] - lower[k] * dp_prev) * denom
        cp_prev, dp_prev = cp[k], dp[k]
    x = torch.empty_like(rhs)
    x_next = torch.zeros_like(rhs[0])
    for k in range(n - 1, -1, -1):
        x[k] = dp[k] - cp[k] * x_next
        x_next = x[k]
    return x


def spline_flux_solve(Hzk, AK, q, dt):
    """Implicit vertical-flux solve with parabolic-spline
    reconstruction (SPLINES_VVISC / SPLINES_VDIFF; step3d_uv.F:393-437).

    Solves FC(k) DC(k-1) + BC(k) DC(k) + CF(k) DC(k+1) = q(k+1) - q(k)
    at interfaces k = 1..N-1 with DC(0) = DC(N) = 0 and returns
    dq(k) = dt/Hzk(k) * (AK(k) DC(k) - AK(k-1) DC(k-1)).
    Hzk, q: (N, ...); AK: (N+1, ...).
    """
    oHz = 1.0 / Hzk
    sixth = 1.0 / 6.0
    third = 1.0 / 3.0
    FC = sixth * Hzk[:-1] - dt * AK[:-2] * oHz[:-1]
    CF = sixth * Hzk[1:] - dt * AK[2:] * oHz[1:]
    BC = (third * (Hzk[:-1] + Hzk[1:])
          + dt * AK[1:-1] * (oHz[:-1] + oHz[1:]))
    DC_int = tridiag_solve(FC, BC, CF, q[1:] - q[:-1])
    zeros = torch.zeros_like(q[:1])
    flux = AK * torch.cat([zeros, DC_int, zeros], dim=0)
    return dt * oHz * (flux[1:] - flux[:-1])
