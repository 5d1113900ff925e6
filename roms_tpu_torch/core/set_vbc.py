"""Bottom stress (port of roms_tpu/core/set_vbc.py; set_vbc.F).

This slice carries the linear drag law (UV_LDRAG) with the
reference's 0.75/dt sign-preserving limiter.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops import stencil as st


def bottom_drag(cfg: ModelConfig, grid, u, v, Hz, z_r=None, z_w=None):
    """Kinematic bottom stress (bustr, bvstr) in m2/s2; k=0 is the
    bottom level."""
    d = cfg.drag
    ub, vb = u[0], v[0]
    if d.kind == "none":
        return torch.zeros_like(ub), torch.zeros_like(vb)
    if d.kind != "linear":
        raise NotImplementedError(
            f"bottom drag '{d.kind}': the BENCHMARK slice (slice 3)")
    cff = 0.75 / cfg.dt
    Hz_u = st.avg_x(Hz[0])
    Hz_v = st.avg_y(Hz[0])
    bustr = d.rdrg * ub
    bvstr = d.rdrg * vb
    bustr = torch.sign(bustr) * torch.minimum(torch.abs(bustr),
                                              torch.abs(ub) * cff * Hz_u)
    bvstr = torch.sign(bvstr) * torch.minimum(torch.abs(bvstr),
                                              torch.abs(vb) * cff * Hz_v)
    return bustr, bvstr
