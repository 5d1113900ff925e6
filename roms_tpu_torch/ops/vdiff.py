"""Kernel 5: spline implicit vertical diffusion of all tracers
(csrc/vdiff.cu).

Replaces roms_tpu/ops/pallas_vdiff.py `spline_vdiff_pallas`; the
column solve is shared with kernel 4 (csrc/spline_dq.cuh).
"""

from __future__ import annotations

import torch

from . import _lib
from .tridiag import spline_flux_solve


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
    (pre, Hz, Akt), sfx, stream = _lib.prepare("spline_vdiff",
                                               [pre, Hz, Akt])
    NT, N, Mj, Li = pre.shape
    NAT = Akt.shape[0]
    _lib.require_depth("spline_vdiff", N)
    if Hz.shape != (N, Mj, Li) or Akt.shape[1:] != (N + 1, Mj, Li):
        raise ValueError("spline_vdiff: inconsistent shapes")
    out = torch.empty_like(pre)
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_vdiff_{sfx}", [P] * 4 + [I] * 5 + [D, P])
    rc = fn(*[_lib.ptr(x) for x in (Hz, Akt, pre, out)],
            NT, NAT, N, Mj, Li, float(cfg.dt), P(stream))
    _lib.launches["spline_vdiff"] += 1
    _lib.check(rc, "spline_vdiff")
    return out
