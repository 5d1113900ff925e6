"""Vertical mass flux (port of roms_tpu/core/omega.py; omega.F:200-345):
integrate the horizontal mass-flux divergence up from the bottom, then
subtract the moving-coordinate drift so W vanishes at the surface.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops import stencil as st
from . import boundary


def omega(cfg: ModelConfig, grid, Huon, Hvom, z_w):
    """W at interfaces (N+1, Mj, Li); W[0] = W[N] = 0."""
    div = (st.ip1(Huon) - Huon) + (st.jp1(Hvom) - Hvom)
    Wk = -torch.cumsum(div, dim=0)
    W = torch.cat([torch.zeros_like(Wk[:1]), Wk], dim=0)
    wrk = W[-1] / (z_w[-1] - z_w[0])
    W = W - wrk[None] * (z_w - z_w[:1])
    W[-1] = 0.0
    return boundary.bc_rho(W, cfg.bc.zeta)
