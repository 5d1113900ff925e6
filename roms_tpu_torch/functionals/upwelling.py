"""UPWELLING analytical test application (port of
roms_tpu/functionals/upwelling.py).

The reference's default test (ROMS_APPLICATION=UPWELLING, makefile:78):
a wind-driven coastal upwelling channel, periodic east-west, closed
north/south, on an f-plane (southern hemisphere).

Sources:
  grid     ana_grid.h:386-391 (Xsize/Esize=1km*Lm/Mm, depth=150, f0=-8.26e-5)
           ana_grid.h:1058-1075 (EW-periodic branch: h(j) coastal profile)
  initial  ana_initial.h:828-846 (T = T0 + 8 exp(z/50); S = S0; u=v=zeta=0)
  wind     ana_smflux.h:306-330 (EW-periodic: sustr ramps to -0.1/rho0 Pa
           over 2 days; svstr = 0)
  vmix     ana_vmix.h:200-210 (Akv = 2e-3 + 8e-3 exp(z_w/150)); Akt = Akt_bak
  params   roms_upwelling.in (dt=300, ndtfast=30, Vtransform=2/Vstretching=4,
           theta_s=3, Tcline=25, linear EOS R0=1027 T0=14 Tcoef=1.7e-4,
           VISC2=5, TNU2=0, AKV_BAK=1e-5, AKT_BAK=1e-6, rdrg=3e-4, gamma2=1)

Xsize = 1 km * Lm keeps dx = dy = 1 km at any Lm, Mm, so the published
time steps stay valid when the channel is widened.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants
from ..config import (LBC, BoundaryConfig, BottomDragConfig, EOSConfig,
                      MixingConfig, ModelConfig, VerticalCoordConfig,
                      CENTERED4, UPSTREAM3)
from ..core.state import Forcing, State, initial_state
from ..device import torch_dtype
from ..grid.depth import set_depth
from ..grid.grid import Grid, build_grid


def make_config(Lm: int = 41, Mm: int = 80, N: int = 16,
                dt: float = 300.0, ndtfast: int = 30,
                dtype: str = "float64") -> ModelConfig:
    lbc = LBC.ew_periodic()
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=2, Vstretching=4,
                                 theta_s=3.0, theta_b=0.0, Tcline=25.0),
        eos=EOSConfig(linear=True, R0=1027.0, T0=14.0, S0=35.0,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=5.0, tnu2=(0.0, 0.0),
                            akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
                            vmix="ana_upwelling",
                            splines_vdiff=True, splines_vvisc=True),
        drag=BottomDragConfig(kind="linear", rdrg=3.0e-4),
        bc=BoundaryConfig.uniform(lbc),
        rho0=1025.0, gamma2=1.0,
        hadv=UPSTREAM3, vadv=CENTERED4,
        uv_hadv="up3", uv_vadv="c4_sw",
        uv_cor=True, uv_adv=True, curvgrid=False,
        dtype=dtype,
    )


def make_grid(cfg: ModelConfig, device="cuda") -> Grid:
    """ana_grid.h UPWELLING (EW-periodic branch)."""
    Lm, Mm = cfg.Lm, cfg.Mm
    Mj, Li = cfg.shape2d
    depth = 150.0
    f0 = -8.26e-5
    Xsize = 1000.0 * Lm
    Esize = 1000.0 * Mm
    dx = Xsize / Lm
    dy = Esize / Mm

    i = np.arange(Li, dtype=np.float64)          # rho i = 0..Lm+1
    j = np.arange(Mj, dtype=np.float64)
    xr = (dx * (i - 0.5))[None, :] + np.zeros((Mj, 1))
    yr = (dy * (j - 0.5))[:, None] + np.zeros((1, Li))

    # Bathymetry (ana_grid.h:1071-1083, EW-periodic): ridge profile in j.
    val1 = np.where(j <= Mm / 2, j, Mm + 1 - j)
    h1d = np.minimum(depth, 84.5 + 66.526 * np.tanh((val1 - 10.0) / 7.0))
    h = np.broadcast_to(h1d[:, None], (Mj, Li)).copy()

    return build_grid(cfg, h=h, pm=np.full((Mj, Li), 1.0 / dx),
                      pn=np.full((Mj, Li), 1.0 / dy),
                      f=np.full((Mj, Li), f0), xr=xr, yr=yr,
                      xu=xr - 0.5 * dx, yu=yr, xv=xr, yv=yr - 0.5 * dy,
                      device=device)


def make_initial(cfg: ModelConfig, grid: Grid) -> State:
    """ana_initial.h:828-846."""
    zeta = torch.zeros(cfg.shape2d, dtype=torch_dtype(cfg.dtype),
                       device=grid.device)
    z_r, _, _ = set_depth(grid, zeta)
    T = cfg.eos.T0 + 8.0 * torch.exp(z_r / 50.0)
    S = torch.full_like(T, cfg.eos.S0)
    return initial_state(cfg, grid, zeta=zeta, t=torch.stack([T, S]))


def make_forcing_fn(cfg: ModelConfig, grid: Grid, dstart: float = 0.0):
    """Return forcing(time_seconds) -> Forcing."""
    Mj, Li = cfg.shape2d
    dtype = torch_dtype(cfg.dtype)
    dev = grid.device
    zeros = torch.zeros((Mj, Li), dtype=dtype, device=dev)
    zerosT = torch.zeros((cfg.NT, Mj, Li), dtype=dtype, device=dev)

    def forcing(time):
        tdays = time * constants.sec2day - dstart
        # ana_smflux.h:317-330 (EW-periodic): 2-day ramp of zonal stress.
        if tdays <= 2.0:
            windamp = -0.1 * math.sin(constants.pi * tdays / 4.0) / cfg.rho0
        else:
            windamp = -0.1 / cfg.rho0
        sustr = torch.full((Mj, Li), windamp, dtype=dtype, device=dev)
        return Forcing(sustr=sustr, svstr=zeros, stflx=zerosT,
                       btflx=zerosT, srflx=zeros)

    return forcing


def make_vmix_fn(cfg: ModelConfig):
    """ana_vmix.h:200-210 and 320-336: analytic Akv(z_w), constant Akt."""
    def vmix(state, grid, z_w):
        # Interior interfaces k=1..N-1; endpoints keep the background value.
        Akv = 2.0e-3 + 8.0e-3 * torch.exp(z_w / 150.0)
        Akv[0] = cfg.mixing.akv_bak
        Akv[-1] = cfg.mixing.akv_bak
        Akt = torch.stack([torch.full_like(z_w, ab)
                           for ab in cfg.mixing.akt_bak])
        return Akv, Akt

    return vmix
