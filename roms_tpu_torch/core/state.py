"""Model state and forcing (port of roms_tpu/core/state.py).

The reference's rotating time slots are resolved into named time
levels, as in roms_tpu (see its core/state.py for the slot mapping).
`time` and `iic` are host Python numbers here: the start-up branches
keyed on `iic` are then plain Python, with no device sync.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..config import ModelConfig
from ..device import torch_dtype
from ..grid.depth import set_depth
from ..grid.grid import Grid
from ..ops import stencil as st
from .gls import initial_mix
from .my25 import initial_mix_my25


class Forcing(NamedTuple):
    sustr: torch.Tensor     # kinematic surface U-stress (m2/s2), U points
    svstr: torch.Tensor     # V points
    stflx: torch.Tensor     # (NT, Mj, Li) surface tracer flux
    btflx: torch.Tensor     # bottom tracer flux
    srflx: torch.Tensor     # shortwave


class State(NamedTuple):
    time: float             # seconds since initialization
    iic: int                # completed baroclinic steps

    zeta: torch.Tensor      # (Mj, Li) free surface, fast-time averaged
    ubar: torch.Tensor
    vbar: torch.Tensor

    u: torch.Tensor         # (N, Mj, Li)
    v: torch.Tensor
    t: torch.Tensor         # (NT, N, Mj, Li)
    t_prev: torch.Tensor

    ru_prev: torch.Tensor   # (N, Mj, Li) 3D RHS history (AB3)
    rv_prev: torch.Tensor
    ru_prev2: torch.Tensor
    rv_prev2: torch.Tensor

    ru0_prev: torch.Tensor  # (Mj, Li) 2D coupling forcing history
    rv0_prev: torch.Tensor
    ru0_prev2: torch.Tensor
    rv0_prev2: torch.Tensor

    z_r: torch.Tensor       # (N, Mj, Li)
    z_w: torch.Tensor       # (N+1, Mj, Li)
    Hz: torch.Tensor        # (N, Mj, Li)

    # GLS/MY2.5 turbulence state (core/gls.py MixState), None otherwise
    mix: Any = None


def initial_state(cfg: ModelConfig, grid: Grid, *, zeta=None, u=None,
                  v=None, t=None, time0: float = 0.0) -> State:
    """Cold-start state (initial.F): ubar/vbar are the vertical means
    of u/v; both AB history levels start at zero.  Under GLS or MY2.5
    the turbulence state starts at the closure's minimum levels."""
    dtype = torch_dtype(cfg.dtype)
    dev = grid.device
    Mj, Li = cfg.shape2d
    N, NT = cfg.N, cfg.NT

    def field(x, shape):
        if x is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    zeta = field(zeta, (Mj, Li))
    u = field(u, (N, Mj, Li))
    v = field(v, (N, Mj, Li))
    t = field(t, (NT, N, Mj, Li))
    z_r, z_w, Hz = set_depth(grid, zeta)
    Hz_u = st.avg_x(Hz)
    Hz_v = st.avg_y(Hz)
    ubar = torch.sum(Hz_u * u, dim=0) / torch.sum(Hz_u, dim=0)
    vbar = torch.sum(Hz_v * v, dim=0) / torch.sum(Hz_v, dim=0)
    zeros2 = torch.zeros((Mj, Li), dtype=dtype, device=dev)
    zeros3 = torch.zeros((N, Mj, Li), dtype=dtype, device=dev)
    mix = None
    if cfg.mixing.vmix == "gls":
        mix = initial_mix(cfg, dev)
    elif cfg.mixing.vmix == "my25":
        mix = initial_mix_my25(cfg, dev)
    return State(
        time=float(time0), iic=0,
        zeta=zeta, ubar=ubar, vbar=vbar,
        u=u, v=v, t=t, t_prev=t,
        ru_prev=zeros3, rv_prev=zeros3,
        ru_prev2=zeros3, rv_prev2=zeros3,
        ru0_prev=zeros2, rv0_prev=zeros2,
        ru0_prev2=zeros2, rv0_prev2=zeros2,
        z_r=z_r, z_w=z_w, Hz=Hz, mix=mix)
