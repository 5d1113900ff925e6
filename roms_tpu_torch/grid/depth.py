"""Time-evolving depths and grid-box thicknesses (port of
roms_tpu/grid/depth.py; ROMS/Nonlinear/set_depth.F, Vtransform 1 and 2).

z_w has N+1 interfaces [k, j, i] with k=0 the bottom; z_r has N
mid-levels; Hz[k] = z_w[k+1] - z_w[k].
"""

from __future__ import annotations

import torch

from ..ops import stencil as st
from .grid import Grid


def set_depth(grid: Grid, zeta):
    """(z_r, z_w, Hz) for the free surface `zeta` at RHO points."""
    if grid.zice is not None:
        raise NotImplementedError("ICESHELF set_depth: ROADMAP Queue 1 item 8")
    h = grid.h
    hc = grid.hc
    sc_r = grid.sc_r[:, None, None]
    Cs_r = grid.Cs_r[:, None, None]
    sc_w = grid.sc_w[1:, None, None]
    Cs_w = grid.Cs_w[1:, None, None]
    if grid.Vtransform == 1:
        z_w0 = hc * (sc_w - Cs_w) + Cs_w * h[None]
        z_r0 = hc * (sc_r - Cs_r) + Cs_r * h[None]
        z_w_up = z_w0 + zeta[None] * (1.0 + z_w0 / h[None])
        z_r = z_r0 + zeta[None] * (1.0 + z_r0 / h[None])
    else:
        hinv = 1.0 / (hc + h)[None]
        zo_w = (hc * sc_w + Cs_w * h[None]) * hinv
        zo_r = (hc * sc_r + Cs_r * h[None]) * hinv
        z_w_up = zeta[None] + (zeta + h)[None] * zo_w
        z_r = zeta[None] + (zeta + h)[None] * zo_r
    z_w = torch.cat([-h[None], z_w_up], dim=0)
    Hz = z_w[1:] - z_w[:-1]
    return z_r, z_w, Hz


def set_massflux(grid: Grid, u, v, Hz):
    """Huon = Hz_u*u*on_u, Hvom = Hz_v*v*om_v (set_massflux.F:140-163)."""
    Hz_u = 0.5 * (Hz + st.im1(Hz))
    Hz_v = 0.5 * (Hz + st.jm1(Hz))
    return Hz_u * u * grid.on_u[None], Hz_v * v * grid.om_v[None]
