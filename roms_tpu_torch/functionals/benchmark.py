"""BENCHMARK analytical application (port of
roms_tpu/functionals/benchmark.py): the reference's scaling benchmark
(ROMS/Include/benchmark.h, ROMS/External/roms_benchmark{1,2,3}.in), an
idealized Southern Ocean channel: spherical, 360 degrees of longitude at
70S-50S, 4000 m deep, EW-periodic with closed N/S walls.

Sources:
  grid     ana_grid.h:243-248 (Xsize=360 deg, Esize=20 deg, depth=4000)
           ana_grid.h:462-482 (spherical lon/lat), :677-689 (pm, pn),
           :870-876 (full Coriolis f = 2*Omega*sin(lat))
  initial  ana_initial.h:545-557 (T(z) exponential-tanh; S=35)
  wind     ana_winds.h:118-126 (zonal gaussian jet at 60S, 15 m/s);
           the full-physics path runs it through COARE bulk fluxes
           (make_bulk_forcing_fn), the light variant through a
           constant-Cd stress law (make_forcing_fn)
  params   roms_benchmark3.in (dt=150, ndtfast=20, theta_s=theta_b=0,
           Tcline=400, nonlinear EOS, quadratic drag rdrg2, VISC2=5000,
           TNU2=500, AKV_BAK=1e-4)

full_physics=True is the reference's benchmark.h CPP set: LMD-KPP
(vmix='lmd') with SOLAR_SOURCE, with make_bulk_forcing_fn for
BULK_FLUXES + LONGWAVE + ALBEDO; MIX_GEO_TS, JM95 and quadratic drag are
on in both variants.  BENCHMARK3 is Lm=2048, Mm=256, N=30 (bench.py).
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


def make_config(Lm: int = 512, Mm: int = 64, N: int = 30,
                dt: float = 150.0, ndtfast: int = 20,
                dtype: str = "float32",
                full_physics: bool = False) -> ModelConfig:
    lbc = LBC.ew_periodic()
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=2, Vstretching=4,
                                 theta_s=0.0, theta_b=0.0, Tcline=400.0),
        eos=EOSConfig(linear=False),
        mixing=MixingConfig(visc2=5000.0, tnu2=(500.0, 500.0),
                            akv_bak=1.0e-4, akt_bak=(1.0e-5, 1.0e-5),
                            vmix="lmd" if full_physics else "constant",
                            solar_source=full_physics,
                            mix_geo_ts=True,
                            splines_vdiff=True, splines_vvisc=True),
        drag=BottomDragConfig(kind="quadratic", rdrg2=3.0e-3),
        bc=BoundaryConfig.uniform(lbc),
        rho0=1025.0, gamma2=1.0,
        hadv=UPSTREAM3, vadv=CENTERED4,
        uv_hadv="up3", uv_vadv="c4_sw",
        uv_cor=True, uv_adv=True, curvgrid=True,
        dtype=dtype,
    )


def make_grid(cfg: ModelConfig, device="cuda") -> Grid:
    """Spherical channel grid (ana_grid.h BENCHMARK branches)."""
    Lm, Mm = cfg.Lm, cfg.Mm
    Mj, Li = cfg.shape2d
    Xsize, Esize, depth = 360.0, 20.0, 4000.0
    dx = Xsize / Lm                   # degrees lon
    dy = Esize / Mm                   # degrees lat
    Er = constants.Eradius
    d2r = constants.deg2rad

    i = np.arange(Li, dtype=np.float64)
    j = np.arange(Mj, dtype=np.float64)
    lonr = (dx * (i - 0.5))[None, :] + np.zeros((Mj, 1))
    latr = (-70.0 + dy * (j - 0.5))[:, None] + np.zeros((1, Li))

    # pm = 1/dx_m: ana_grid.h:681-689
    val1 = Lm / (2.0 * np.pi * Er)
    val2 = Mm * 360.0 / (2.0 * np.pi * Er * Esize)
    pm = val1 / np.cos(latr * d2r) * np.ones_like(lonr)
    pn = val2 * np.ones_like(lonr)

    # full Coriolis (ana_grid.h:870-876)
    omega2 = 2.0 * (2.0 * np.pi * 366.25 / 365.25) / 86400.0
    f = omega2 * np.sin(latr * d2r)

    h = np.full((Mj, Li), depth)
    xr = Er * d2r * lonr * np.cos(latr * d2r)
    yr = Er * d2r * latr
    return build_grid(cfg, h=h, pm=pm, pn=pn, f=f, xr=xr, yr=yr,
                      spherical=True, device=device)


def make_initial(cfg: ModelConfig, grid: Grid) -> State:
    """ana_initial.h:545-557."""
    zeta = torch.zeros(cfg.shape2d, dtype=torch_dtype(cfg.dtype),
                       device=grid.device)
    z_r, _, _ = set_depth(grid, zeta)
    g = constants.g
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * 800.0 / g) * (5.0e-5 / ((42.689 / 44.69) ** 2))
    T = val2 * torch.exp(z_r / 800.0) * \
        (0.6 - 0.4 * torch.tanh(z_r / 800.0))
    S = torch.full_like(T, 35.0)
    return initial_state(cfg, grid, zeta=zeta, t=torch.stack([T, S]))


def make_atm_fn(cfg: ModelConfig, grid: Grid):
    """Analytical atmosphere for BULK_FLUXES: Gaussian zonal wind jet at
    60S (ana_winds.h:118-126), Tair=4 C (ana_tair.h:86-91), Pair=1025 mb
    (ana_pair.h:87-92), RH=0.8 (ana_humid.h:93-98), cloud=0.6
    (ana_cloud.h:116-117), Zillman shortwave with 6% water albedo and a
    diurnal cycle (ana_srflux.h:165-192, ALBEDO).  Positions come from
    the grid's own coordinates (float64 on the host, as roms_tpu folds
    them to numpy constants)."""
    from ..core.bulk_flux import AtmState
    dtype = torch_dtype(cfg.dtype)
    dev = grid.device
    d2r = constants.deg2rad
    Er = constants.Eradius
    yr = grid.yr.double().cpu().numpy()
    xr = grid.xr.double().cpu().numpy()
    lat = yr / (Er * d2r)
    lon = xr / (Er * d2r * np.cos(lat * d2r))
    cffw = 0.2 * (60.0 + lat)

    def tensor(a):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    Uwind = tensor(15.0 * np.exp(-cffw * cffw))
    zeros = torch.zeros_like(Uwind)
    Tair = torch.full_like(Uwind, 4.0)
    Pair = torch.full_like(Uwind, 1025.0)
    Hair = torch.full_like(Uwind, 0.8)
    cloud = torch.full_like(Uwind, 0.6)
    latr = tensor(lat * d2r)
    lonr = tensor(lon * d2r)
    sin_lat, cos_lat = torch.sin(latr), torch.cos(latr)
    Rsolar = 1353.0 / (cfg.rho0 * constants.Cp)
    alb_w = 0.06
    cffT = (0.7859 + 0.03477 * 4.0) / (1.0 + 0.00412 * 4.0)
    vap_p = (10.0 ** cffT) * 0.8

    def atm(time):
        # day of year and hour from the model clock (an idealized year
        # starting Jan 1)
        tdays = time * constants.sec2day
        yday = math.fmod(tdays, 365.2425)
        hour = 24.0 * math.fmod(tdays, 1.0)
        Dangle = (23.44 * math.cos((172.0 - yday) * 2.0 * math.pi
                                   / 365.2425)) * constants.deg2rad
        Hangle = (12.0 - hour) * math.pi / 12.0
        cff1 = sin_lat * math.sin(Dangle)
        cff2 = cos_lat * math.cos(Dangle)
        zenith = cff1 + cff2 * torch.cos(Hangle - lonr)
        srflx = torch.where(
            zenith > 0.0,
            Rsolar * zenith * zenith * (1.0 - 0.6 * 0.6 ** 3)
            / ((zenith + 2.7) * vap_p * 1.0e-3 + 1.085 * zenith + 0.1),
            zeros) * (1.0 - alb_w)
        return AtmState(Uwind=Uwind, Vwind=zeros, Tair=Tair, Pair=Pair,
                        Hair=Hair, cloud=cloud, rain=zeros, srflx=srflx)

    return atm


def make_bulk_forcing_fn(cfg: ModelConfig, grid: Grid):
    """Full BULK_FLUXES forcing (benchmark.h) via COARE 3.0:
    forcing(time, sst, sss, rho_surf, use_kernels=True)."""
    from ..core.bulk_flux import make_bulk_forcing
    return make_bulk_forcing(cfg, make_atm_fn(cfg, grid))


def make_forcing_fn(cfg: ModelConfig, grid: Grid):
    """Zonal wind jet (ana_winds.h:118-126) through a constant-Cd stress
    law: the light variant without bulk fluxes."""
    Mj, Li = cfg.shape2d
    dtype = torch_dtype(cfg.dtype)
    dev = grid.device
    lat_u = np.asarray(-70.0 + (20.0 / cfg.Mm)
                       * (np.arange(Mj) - 0.5))[:, None] + np.zeros((1, Li))
    cffw = 0.2 * (60.0 + lat_u)
    Uwind = 15.0 * np.exp(-cffw * cffw)
    rho_air, Cd = 1.2, 1.4e-3
    sustr = torch.as_tensor(rho_air * Cd * np.abs(Uwind) * Uwind
                            / cfg.rho0).to(device=dev, dtype=dtype)
    zeros = torch.zeros((Mj, Li), dtype=dtype, device=dev)
    zerosT = torch.zeros((cfg.NT, Mj, Li), dtype=dtype, device=dev)

    def forcing(time):
        return Forcing(sustr=sustr, svstr=zeros, stflx=zerosT,
                       btflx=zerosT, srflx=zeros)

    return forcing
