"""Kernel 6: spline implicit vertical diffusion of all tracers
(csrc/vdiff.cu).

Replaces roms_tpu/ops/pallas_vdiff.py `spline_vdiff_pallas`.  The
kernel is uv_solve's column sweep (csrc/uv.cu), one thread per tracer
and column, its state in shared memory sized by N
(`vdiff_launch_shape`), bitwise equal to the plain version.
"""

from __future__ import annotations

import torch

from . import _lib
from .tridiag import spline_flux_solve

# threads a block by element size: the sweep keeps 4 N - 2 values a
# thread in shared memory (csrc/vdiff.cu); uv_solve's choice, timed
# against other block sizes by `chip_smoke.py --profile` (PERF.md)
VDIFF_THREADS = {4: 96, 8: 64}


def vdiff_launch_shape(N: int, NT: int, Mj: int, Li: int, itemsize: int):
    """(threads, blocks, dynamic shared memory bytes): NT blocks (one a
    tracer) per range of `threads` columns."""
    B = VDIFF_THREADS[itemsize]
    return B, NT * -(-(Mj * Li) // B), itemsize * (4 * N - 2) * B


def covers(cfg) -> bool:
    """Spline vertical diffusion (use_pallas_vdiff, pallas_vdiff.py:78)."""
    return bool(cfg.mixing.splines_vdiff)


def spline_vdiff_plain(cfg, pre, Hz, Akt):
    """pre: (NT, N, Mj, Li) Hz-weighted tracers; Akt (NAT, N+1, Mj, Li).
    Returns (NT, N, Mj, Li) in tracer units (q + dq)."""
    NAT = Akt.shape[0]
    out = []
    for itrc in range(cfg.NT):
        q = pre[itrc] / Hz
        out.append(q + spline_flux_solve(Hz, Akt[min(itrc, NAT - 1)], q,
                                         cfg.dt))
    return torch.stack(out)


def spline_vdiff(cfg, pre, Hz, Akt):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if pre.device.type == "cpu":
        return spline_vdiff_plain(cfg, pre, Hz, Akt)
    return _launch(cfg, pre, Hz, Akt)


def _launch(cfg, pre, Hz, Akt):
    (pre, Hz, Akt), sfx, stream = _lib.prepare("spline_vdiff",
                                               [pre, Hz, Akt])
    NT, N, Mj, Li = pre.shape
    NAT = Akt.shape[0]
    if N < 2 or Hz.shape != (N, Mj, Li) or \
            Akt.shape[1:] != (N + 1, Mj, Li):
        raise ValueError("spline_vdiff: inconsistent shapes")
    threads, _, smem = vdiff_launch_shape(N, NT, Mj, Li, pre.element_size())
    if smem > _lib.SMEM_PER_BLOCK:
        raise ValueError(f"spline_vdiff: {N} levels need {smem} B of shared "
                         "memory a block, more than the card's 227 KB")
    out = torch.empty_like(pre)
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_vdiff_{sfx}", [P] * 4 + [I] * 5 + [D, I, P])
    rc = fn(*[_lib.ptr(x) for x in (Hz, Akt, pre, out)],
            NT, NAT, N, Mj, Li, float(cfg.dt), threads, P(stream))
    _lib.launches["spline_vdiff"] += 1
    _lib.check(rc, "spline_vdiff")
    return out
