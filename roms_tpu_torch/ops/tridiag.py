"""Kernel 17: the batched vertical tridiagonal solve (csrc/tridiag.cu),
and the spline flux solve behind kernels 4 and 6.

Replaces roms_tpu/ops/pallas_tridiag.py `tridiag_solve_pallas`, which
roms_tpu's dispatcher (roms_tpu/ops/tridiag.py:32-57) runs for every
3-D solve with N <= 128 on one TPU; the GLS and MY2.5 closures reach it
four times a step (core/gls.py, core/my25.py).  Arrays are [k, ...]
with k axis 0.

The kernel runs one thread a (j, i) column, its cp and dp in shared
memory, with blocks sized by N and the element size (`launch_shape`).

`tridiag_plain` is the plain PyTorch Thomas sweep over whole horizontal
planes, with the Pallas kernel's association (_thomas_kernel,
pallas_tridiag.py:33-57).  `spline_flux_solve` stays on it: it is the
plain version of kernels 4 and 6 (ops/uv.py, ops/vdiff.py; their CUDA
sweeps are in csrc/uv.cu and csrc/vdiff.cu), so
`Model(use_kernels=False)` never launches kernel 17.
"""

from __future__ import annotations

import torch

from . import _lib

# roms_tpu's call-site bound on the depth of a kernel solve
# (roms_tpu/ops/tridiag.py:55): the class the kernel takes, which fits a
# block's shared memory in either type (launch_shape)
NMAX = 128

# the most threads a block (csrc/tridiag.cu kThreadsTridiag), by element
# size; fewer where a column's cp and dp (2 N values a thread, in shared
# memory) would not fit a block
THREADS = {4: 256, 8: 128}


def launch_shape(N: int, Mj: int, Li: int, itemsize: int):
    """(threads, blocks, dynamic shared memory bytes) of the kernel's
    launch: THREADS[itemsize], cut to a multiple of 32 whose cp and dp fit
    a block's shared memory (96 threads for 128 float64 levels); past a
    warp's fit the kernel refuses the launch."""
    B = max(32, min(THREADS[itemsize],
                    _lib.SMEM_PER_BLOCK // (2 * N * itemsize) // 32 * 32))
    return B, -(-(Mj * Li) // B), itemsize * 2 * N * B


def covers(rhs) -> bool:
    """Kernel 17's class, roms_tpu's gate for the Pallas solve
    (ops/tridiag.py:51-57): a 3-D operand of at most NMAX levels.  The
    closures decide from it at their call sites (core/gls.py
    `closure_solve`); the wrapper refuses what it does not cover."""
    return rhs.dim() == 3 and rhs.shape[0] <= NMAX


def tridiag_plain(lower, diag, upper, rhs):
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


def tridiag_solve(lower, diag, upper, rhs, use_kernels: bool = True):
    """Wrapper: the kernel on CUDA tensors, raising where it cannot
    launch (operands outside `covers`); the plain sweep on CPU tensors
    or when `use_kernels` is False."""
    if not use_kernels or rhs.device.type == "cpu":
        return tridiag_plain(lower, diag, upper, rhs)
    if not covers(rhs):
        raise ValueError(f"tridiag: operand of shape {tuple(rhs.shape)} "
                         f"is not 3-D with at most {NMAX} levels")
    (lower, diag, upper, rhs), sfx, stream = _lib.prepare(
        "tridiag", [lower, diag, upper, rhs])
    return _launch(sfx, stream, lower, diag, upper, rhs)


def _launch(sfx, stream, lower, diag, upper, rhs):
    N, Mj, Li = rhs.shape
    for t in (lower, diag, upper):
        if t.shape != rhs.shape:
            raise ValueError("tridiag: inconsistent shapes")
    B = launch_shape(N, Mj, Li, rhs.element_size())[0]
    out = torch.empty_like(rhs)
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_tridiag_{sfx}", [P] * 5 + [I] * 4 + [P])
    rc = fn(*[_lib.ptr(x) for x in (lower, diag, upper, rhs, out)],
            N, Mj, Li, B, P(stream))
    _lib.launches["tridiag"] += 1
    _lib.check(rc, "tridiag")
    return out


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
    DC_int = tridiag_plain(FC, BC, CF, q[1:] - q[:-1])
    zeros = torch.zeros_like(q[:1])
    flux = AK * torch.cat([zeros, DC_int, zeros], dim=0)
    return dt * oHz * (flux[1:] - flux[:-1])
