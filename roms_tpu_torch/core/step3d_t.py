"""Tracer corrector (port of roms_tpu/core/step3d_t.py; step3d_t.F):
advection of the half-step tracer by the time-centred mass fluxes
(kernel 2, corrector mode, in its class; else core/advection.py), then
spline implicit vertical diffusion of all tracers (kernel 5), then the
lateral BCs.
"""

from __future__ import annotations

from ..config import ModelConfig
from ..grid.grid import Grid
from . import boundary


def step3d_t(cfg: ModelConfig, grid: Grid, t_half, t_part,
             Huon, Hvom, W, Hz, Akt, use_kernels: bool = True):
    """t at n+1 (NT, N, Mj, Li).  Hz: NEW thickness; Huon/Hvom/W the
    time-centred fluxes; Akt (NAT, N+1, Mj, Li)."""
    if not cfg.mixing.splines_vdiff:
        raise NotImplementedError(
            "non-spline vertical diffusion: ROADMAP Queue 1 item 7")
    from ..ops import tadv, vdiff
    from .advection import tracer_corrector
    if tadv.covers(cfg):
        adv = tadv.corrector if use_kernels else tadv.corrector_plain
    else:
        adv = tracer_corrector
    diff = vdiff.spline_vdiff if use_kernels else vdiff.spline_vdiff_plain
    pre = adv(cfg, grid, t_half, t_part, Huon, Hvom, W, Hz)
    tn = diff(cfg, pre, Hz, Akt)
    return boundary.bc_rho(tn, cfg.bc.t)
