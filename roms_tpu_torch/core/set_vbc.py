"""Bottom stress (port of roms_tpu/core/set_vbc.py; set_vbc.F).

The linear (UV_LDRAG), quadratic (UV_QDRAG) and logarithmic
(UV_LOGDRAG) drag laws, each with the reference's 0.75/dt
sign-preserving limiter, and no drag.  The ICESHELF cavity stress is
ROADMAP Queue 1 item 8 (the grids refuse `zice`).
"""

from __future__ import annotations

import torch

from .. import constants
from ..config import ModelConfig
from ..ops import stencil as st


def log_drag_coef(cfg: ModelConfig, z_r, z_w):
    """The log-layer drag coefficient at rho points (set_vbc.F
    UV_LOGDRAG): (vonKar / log((z_r[0] - z_w[0]) / Zob))**2 clipped to
    [Cdb_min, Cdb_max]."""
    d = cfg.drag
    cff1 = 1.0 / torch.log((z_r[0] - z_w[0]) / d.Zob)
    return torch.clamp(constants.vonKar ** 2 * cff1 * cff1, d.Cdb_min,
                       d.Cdb_max)


def _quad_stress(cd_u, cd_v, ub, vb):
    """cd |u| u at U and V points with the four-point averages of the
    other component (set_vbc.F)."""
    v_at_u = 0.25 * (vb + st.jp1(vb) + st.im1(vb) + st.im1(st.jp1(vb)))
    u_at_v = 0.25 * (ub + st.ip1(ub) + st.jm1(ub) + st.jm1(st.ip1(ub)))
    return (cd_u * ub * torch.sqrt(ub * ub + v_at_u * v_at_u),
            cd_v * vb * torch.sqrt(vb * vb + u_at_v * u_at_v))


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
        bustr, bvstr = _quad_stress(d.rdrg2, d.rdrg2, ub, vb)
    elif d.kind == "log":
        cd = log_drag_coef(cfg, z_r, z_w)
        bustr, bvstr = _quad_stress(st.avg_x(cd), st.avg_y(cd), ub, vb)
    else:
        raise ValueError(f"bottom drag '{d.kind}'")
    cff = 0.75 / cfg.dt
    Hz_u = st.avg_x(Hz[0])
    Hz_v = st.avg_y(Hz[0])
    bustr = torch.sign(bustr) * torch.minimum(torch.abs(bustr),
                                              torch.abs(ub) * cff * Hz_u)
    bvstr = torch.sign(bvstr) * torch.minimum(torch.abs(bvstr),
                                              torch.abs(vb) * cff * Hz_v)
    return bustr, bvstr
