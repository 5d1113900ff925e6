"""Bottom stress (port of roms_tpu/core/set_vbc.py; set_vbc.F).

The linear (UV_LDRAG) and quadratic (UV_QDRAG) drag laws, each with the
reference's 0.75/dt sign-preserving limiter, and no drag; the
logarithmic law is ROADMAP Queue 1 item 4.
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
    if d.kind == "linear":
        bustr = d.rdrg * ub
        bvstr = d.rdrg * vb
    elif d.kind == "quadratic":
        v_at_u = 0.25 * (vb + st.jp1(vb) + st.im1(vb) + st.im1(st.jp1(vb)))
        u_at_v = 0.25 * (ub + st.ip1(ub) + st.jm1(ub) + st.jm1(st.ip1(ub)))
        bustr = d.rdrg2 * ub * torch.sqrt(ub * ub + v_at_u * v_at_u)
        bvstr = d.rdrg2 * vb * torch.sqrt(vb * vb + u_at_v * u_at_v)
    else:
        raise NotImplementedError(
            f"bottom drag '{d.kind}': ROADMAP Queue 1 item 4")
    cff = 0.75 / cfg.dt
    Hz_u = st.avg_x(Hz[0])
    Hz_v = st.avg_y(Hz[0])
    bustr = torch.sign(bustr) * torch.minimum(torch.abs(bustr),
                                              torch.abs(ub) * cff * Hz_u)
    bvstr = torch.sign(bvstr) * torch.minimum(torch.abs(bvstr),
                                              torch.abs(vb) * cff * Hz_v)
    return bustr, bvstr
