"""Analytical applications (port of roms_tpu/functionals/idealized.py).

This slice carries DOUBLE_GYRE (ana_grid.h:273-278, ana_initial.h:
631-645, ana_smflux.h:198-209): a closed flat-bottom beta-plane basin
spun up by an antisymmetric zonal wind stress.  The other applications
arrive with the physics they need.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import (BottomDragConfig, BoundaryConfig, EOSConfig,
                      MixingConfig, ModelConfig, VerticalCoordConfig,
                      UPSTREAM3, CENTERED4)
from ..core.state import Forcing, State, initial_state
from ..device import torch_dtype
from ..grid.depth import set_depth
from ..grid.grid import Grid, build_grid

_ESIZE = 2000.0e3       # DOUBLE_GYRE basin length in eta (m)


def _plane_grid(cfg, Xsize, Esize, depth, f0, beta=0.0, h2d=None,
                device="cuda"):
    Mj, Li = cfg.shape2d
    dx = Xsize / cfg.Lm
    dy = Esize / cfg.Mm
    i = np.arange(Li, dtype=np.float64)
    j = np.arange(Mj, dtype=np.float64)
    xr = (dx * (i - 0.5))[None, :] + np.zeros((Mj, 1))
    yr = (dy * (j - 0.5))[:, None] + np.zeros((1, Li))
    pm = np.full((Mj, Li), 1.0 / dx)
    pn = np.full((Mj, Li), 1.0 / dy)
    f = f0 + beta * (yr - 0.5 * Esize)
    h = np.full((Mj, Li), depth) if h2d is None else h2d(xr, yr)
    return build_grid(cfg, h=h, pm=pm, pn=pn, f=np.broadcast_to(
        f, (Mj, Li)).copy(), xr=xr, yr=yr, device=device)


def basin_config(Lm: int = 60, Mm: int = 50, N: int = 10,
                 dt: float = 1800.0, ndtfast: int = 30,
                 dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=0.001, theta_b=0.0, Tcline=1e16),
        eos=EOSConfig(linear=True, R0=1028.0, T0=0.0, S0=35.0,
                      Tcoef=1.0e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=1300.0, tnu2=(1300.0, 1300.0),
                            akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6)),
        drag=BottomDragConfig(kind="linear", rdrg=3.0e-4),
        bc=BoundaryConfig(),
        rho0=1025.0, gamma2=1.0,
        hadv=UPSTREAM3, vadv=CENTERED4,
        uv_hadv="up3", uv_vadv="c4_sw",
        uv_cor=True, uv_adv=True, curvgrid=False,
        dtype=dtype,
    )


def double_gyre_config(Lm: int = 50, Mm: int = 100, N: int = 10,
                       dt: float = 1800.0, ndtfast: int = 30,
                       dtype: str = "float64") -> ModelConfig:
    cfg = basin_config(Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
                       dtype=dtype)
    return cfg.replace(
        eos=EOSConfig(linear=True, R0=1027.0, T0=14.0, S0=34.5,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=800.0, tnu2=(800.0, 800.0),
                            akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6)))


def double_gyre_grid(cfg: ModelConfig, device="cuda") -> Grid:
    return _plane_grid(cfg, 1000.0e3, _ESIZE, 500.0, f0=7.3e-5,
                       beta=2.0e-11, device=device)


def _yr(cfg: ModelConfig):
    Mj, Li = cfg.shape2d
    dy = _ESIZE / cfg.Mm
    return (dy * (np.arange(Mj) - 0.5))[:, None] + np.zeros((1, Li))


def double_gyre_initial(cfg: ModelConfig, grid: Grid) -> State:
    dtype = torch_dtype(cfg.dtype)
    zeta = torch.zeros(cfg.shape2d, dtype=dtype, device=grid.device)
    z_r, _, _ = set_depth(grid, zeta)
    yr = torch.as_tensor(_yr(cfg)).to(device=grid.device, dtype=dtype)
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * 100.0 / 9.81) * \
        (5.0e-5 / ((42.689 / 44.69) ** 2))
    val4 = yr / _ESIZE
    T = cfg.eos.T0 + val2 * torch.exp(z_r / 100.0) * \
        (10.0 - 0.4 * torch.tanh(z_r / 100.0)) - 3.0 * val4[None]
    S = 34.5 - 0.001 * z_r - val4[None]
    return initial_state(cfg, grid, t=torch.stack([T, S]))


def double_gyre_forcing_fn(cfg: ModelConfig, grid: Grid):
    """sustr = -(0.05/rho0) cos(2 pi y/L) (ana_smflux.h:198-209)."""
    Mj, Li = cfg.shape2d
    dtype = torch_dtype(cfg.dtype)
    dev = grid.device
    sustr = torch.as_tensor(
        -0.05 / cfg.rho0 * np.cos(2.0 * math.pi * _yr(cfg) / _ESIZE)
    ).to(device=dev, dtype=dtype)
    zeros = torch.zeros((Mj, Li), dtype=dtype, device=dev)
    zerosT = torch.zeros((cfg.NT, Mj, Li), dtype=dtype, device=dev)

    def forcing(time):
        return Forcing(sustr=sustr, svstr=zeros, stflx=zerosT,
                       btflx=zerosT, srflx=zeros)

    return forcing
