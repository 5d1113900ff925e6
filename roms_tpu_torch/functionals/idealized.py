"""Analytical applications (port of roms_tpu/functionals/idealized.py).

The applications whose configurations use only the physics the port
runs (constant, GLS or LMD vertical mixing, linear/quadratic/log/no
drag, UP3/C4, djs, LF-AM3, closed or periodic walls, no hooks):

BASIN       big flat closed basin, ramped wind (ana_grid.h:237-242,
            ana_initial.h:559-569, ana_smflux.h:141-152);
DOUBLE_GYRE closed flat-bottom beta-plane basin spun up by an
            antisymmetric zonal wind stress (ana_grid.h:273-278,
            ana_initial.h:631-645, ana_smflux.h:198-209);
SEAMOUNT    4500 m Gaussian seamount over 5000 m, the pressure-gradient
            error test (ana_grid.h:346-352, 1032-1039; ana_initial.h:
            809-816);
GRAV_ADJ    lock exchange in a 64 km x 20 m channel, no Coriolis, no drag
            (ana_grid.h:298-304, ana_initial.h:672-686);
CANYON      stratified flow over a coastal canyon in a periodic channel
            with geopotential tracer mixing (ana_grid.h:261-266, 946-953;
            ana_initial.h:598-607);
WINDBASIN   wind-driven homogeneous rotating basin (ana_grid.h:376-381,
            ana_initial.h:850-859, ana_smflux.h:331-340);
CHANNEL     geostrophically balanced Gaussian jet in a periodic f-plane
            channel (ana_grid.h:255-260, ana_initial.h:218-230, 349-367);
LAKE_SIGNELL wind-driven closed lake with GLS mixing and logarithmic drag
            (ana_grid.h:310-315, 1000-1003; ana_smflux.h:219-231);
LMD_TEST    doubly periodic KPP mixed-layer deepening under a wind pulse,
            LMD with the bottom boundary layer (ana_initial.h:719-730,
            ana_smflux.h:236-250);
MIXED_LAYER doubly periodic GLS surface mixed layer with logarithmic drag
            (ana_initial.h:731-742, ana_smflux.h:189-197);
LAB_CANYON  rotating-table polar annulus, NS-periodic and curvilinear,
            with a shelf-break canyon and geopotential tracer mixing
            (ana_grid.h:305-309, 483-514, 960-991).

Each grid function takes `device="cuda"` (the default raises without a
card) like every entry point of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import (CLOSED, LBC, PERIODIC, BottomDragConfig,
                      BoundaryConfig, EOSConfig, MixingConfig, ModelConfig,
                      VerticalCoordConfig, UPSTREAM3, CENTERED4)
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


def _yr(cfg: ModelConfig, Esize: float = _ESIZE):
    """yr of a plane grid of length Esize in eta (float64 numpy)."""
    Mj, Li = cfg.shape2d
    dy = Esize / cfg.Mm
    return (dy * (np.arange(Mj) - 0.5))[:, None] + np.zeros((1, Li))


def _tensor(cfg: ModelConfig, grid: Grid, x):
    return torch.as_tensor(x).to(device=grid.device,
                                 dtype=torch_dtype(cfg.dtype))


def _with_tracers(cfg: ModelConfig, grid: Grid, T, **kw) -> State:
    """Cold start with temperature T and salinity S0 everywhere."""
    S = torch.full_like(T, cfg.eos.S0)
    return initial_state(cfg, grid, t=torch.stack([T, S]), **kw)


def _z_r0(cfg: ModelConfig, grid: Grid):
    """z_r of the resting free surface."""
    zeta = torch.zeros(cfg.shape2d, dtype=torch_dtype(cfg.dtype),
                       device=grid.device)
    return set_depth(grid, zeta)[0]


def _forcing(cfg: ModelConfig, grid: Grid, sustr_fn):
    """forcing(time) with sustr = sustr_fn(time) and no other flux."""
    Mj, Li = cfg.shape2d
    dtype = torch_dtype(cfg.dtype)
    zeros = torch.zeros((Mj, Li), dtype=dtype, device=grid.device)
    zerosT = torch.zeros((cfg.NT, Mj, Li), dtype=dtype,
                         device=grid.device)

    def forcing(time):
        sustr = zeros if sustr_fn is None else sustr_fn(time, zeros)
        return Forcing(sustr=sustr, svstr=zeros, stflx=zerosT,
                       btflx=zerosT, srflx=zeros)

    return forcing


def zero_forcing(cfg: ModelConfig, grid: Grid):
    """No surface or bottom fluxes (the apps without analytic forcing;
    roms_tpu's zero_forcing(cfg) with the grid's device)."""
    return _forcing(cfg, grid, None)


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


def basin_grid(cfg: ModelConfig, device="cuda") -> Grid:
    return _plane_grid(cfg, 3600.0e3, 2800.0e3, 5000.0, f0=1.0e-4,
                       beta=2.0e-11, device=device)


def basin_initial(cfg: ModelConfig, grid: Grid) -> State:
    z_r = _z_r0(cfg, grid)
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * 800.0 / 9.81) * \
        (5.0e-5 / ((42.689 / 44.69) ** 2))
    T = val2 * torch.exp(z_r / 800.0) * (0.6 - 0.4 * torch.tanh(
        z_r / 800.0))
    return _with_tracers(cfg, grid, T)


def basin_forcing_fn(cfg: ModelConfig, grid: Grid):
    """Ramped sinusoidal zonal wind (ana_smflux.h:141-152)."""
    Esize = 2800.0e3
    cos_y = torch.cos((2.0 * math.pi / Esize) * _tensor(
        cfg, grid, _yr(cfg, Esize)))

    def sustr(time, zeros):
        val1 = 5.0e-5 * (1.0 + math.tanh((time - 6.0 * 86400.0)
                                         / (3.0 * 86400.0)))
        return -val1 * cos_y

    return _forcing(cfg, grid, sustr)


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


def double_gyre_initial(cfg: ModelConfig, grid: Grid) -> State:
    z_r = _z_r0(cfg, grid)
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * 100.0 / 9.81) * \
        (5.0e-5 / ((42.689 / 44.69) ** 2))
    val4 = _tensor(cfg, grid, _yr(cfg)) / _ESIZE
    T = cfg.eos.T0 + val2 * torch.exp(z_r / 100.0) * \
        (10.0 - 0.4 * torch.tanh(z_r / 100.0)) - 3.0 * val4[None]
    S = 34.5 - 0.001 * z_r - val4[None]
    return initial_state(cfg, grid, t=torch.stack([T, S]))


def double_gyre_forcing_fn(cfg: ModelConfig, grid: Grid):
    """sustr = -(0.05/rho0) cos(2 pi y/L) (ana_smflux.h:198-209)."""
    sustr = _tensor(cfg, grid, -0.05 / cfg.rho0 * np.cos(
        2.0 * math.pi * _yr(cfg) / _ESIZE))
    return _forcing(cfg, grid, lambda time, zeros: sustr)


# ---------------------------------------------------------------------------
# SEAMOUNT
# ---------------------------------------------------------------------------

def seamount_config(Lm: int = 49, Mm: int = 48, N: int = 13,
                    dt: float = 60.0, ndtfast: int = 20,
                    dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=5.0, theta_b=0.4, Tcline=50.0),
        eos=EOSConfig(linear=True, R0=1027.0, T0=5.0, S0=35.0,
                      Tcoef=1.0e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=100.0, tnu2=(100.0, 100.0),
                            akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6)),
        drag=BottomDragConfig(kind="linear", rdrg=3.0e-4),
        bc=BoundaryConfig(),           # closed basin
        rho0=1025.0, gamma2=1.0,
        hadv=UPSTREAM3, vadv=CENTERED4,
        uv_hadv="up3", uv_vadv="c4_sw",
        uv_cor=False, uv_adv=True, curvgrid=False,
        dtype=dtype,
    )


def seamount_grid(cfg: ModelConfig, device="cuda") -> Grid:
    def h2d(xr, yr):
        v1 = (xr - 0.5 * 320.0e3) / 40.0e3
        v2 = (yr - 0.5 * 320.0e3) / 40.0e3
        return 5000.0 - 4500.0 * np.exp(-(v1 * v1 + v2 * v2))
    return _plane_grid(cfg, 320.0e3, 320.0e3, 5000.0, f0=0.0, h2d=h2d,
                       device=device)


def seamount_initial(cfg: ModelConfig, grid: Grid) -> State:
    T = cfg.eos.T0 + 7.5 * torch.exp(_z_r0(cfg, grid) / 1000.0)
    return _with_tracers(cfg, grid, T)


# ---------------------------------------------------------------------------
# GRAV_ADJ
# ---------------------------------------------------------------------------

def grav_adj_config(Lm: int = 128, Mm: int = 4, N: int = 40,
                    dt: float = 10.0, ndtfast: int = 20,
                    dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=0.0, theta_b=0.0, Tcline=1e16),
        eos=EOSConfig(linear=True, R0=1027.0, T0=10.0, S0=35.0,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=10.0, tnu2=(5.0, 5.0),
                            akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6)),
        drag=BottomDragConfig(kind="none"),
        bc=BoundaryConfig(),           # closed channel
        rho0=1025.0, gamma2=1.0,
        hadv=UPSTREAM3, vadv=CENTERED4,
        uv_hadv="up3", uv_vadv="c4_sw",
        uv_cor=False, uv_adv=True, curvgrid=False,
        dtype=dtype,
    )


def grav_adj_grid(cfg: ModelConfig, device="cuda") -> Grid:
    Esize = cfg.Mm * 64.0e3 / cfg.Lm
    return _plane_grid(cfg, 64.0e3, Esize, 20.0, f0=0.0, device=device)


def grav_adj_initial(cfg: ModelConfig, grid: Grid) -> State:
    """T0 + 5 for i <= (Lm + 1)/2, T0 beyond (ana_initial.h:672-686)."""
    Mj, Li = cfg.shape2d
    icol = np.arange(Li)
    Tcold = np.where(icol <= (cfg.Lm + 1) // 2, cfg.eos.T0 + 5.0,
                     cfg.eos.T0)
    T = _tensor(cfg, grid, np.broadcast_to(Tcold[None, None, :],
                                           (cfg.N, Mj, Li)).copy())
    return _with_tracers(cfg, grid, T)


# ---------------------------------------------------------------------------
# CANYON — stratified flow over a coastal canyon in a periodic channel
# ---------------------------------------------------------------------------

def canyon_config(Lm: int = 65, Mm: int = 48, N: int = 15,
                  dt: float = 100.0, ndtfast: int = 20,
                  dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=3.5, theta_b=0.0, Tcline=50.0),
        eos=EOSConfig(linear=True, R0=1027.0, T0=14.0, S0=35.0,
                      Tcoef=1.0e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=5.0, tnu2=(1.0, 1.0),
                            mix_geo_ts=True),
        drag=BottomDragConfig(kind="quadratic", rdrg2=3.0e-4),
        bc=BoundaryConfig.uniform(LBC.ew_periodic()),
        rho0=1025.0, gamma2=1.0, prsgrd="djs",
        uv_cor=True, uv_adv=True, dtype=dtype,
    )


def canyon_grid(cfg: ModelConfig, device="cuda") -> Grid:
    """h = 20 + (4000-20)/2 * (1 + tanh((y - yc(x))/10 km)), with the
    shelf break indented by the canyon's sin^24 notch
    (ana_grid.h:946-953)."""
    Xsize, Esize, depth = 128.0e3, 96.0e3, 4000.0

    def h2d(xr, yr):
        val1 = 32000.0 - 16000.0 * np.sin(np.pi * xr / Xsize) ** 24
        return 20.0 + 0.5 * (depth - 20.0) * \
            (1.0 + np.tanh((yr - val1) / 10000.0))

    return _plane_grid(cfg, Xsize, Esize, depth, f0=1.0e-4, h2d=h2d,
                       device=device)


def canyon_initial(cfg: ModelConfig, grid: Grid) -> State:
    z_r = _z_r0(cfg, grid)
    T = 3.488 * torch.exp(z_r / 800.0) * \
        (1.0 - (2.0 / 3.0) * torch.tanh(z_r / 800.0))
    return _with_tracers(cfg, grid, T)


# ---------------------------------------------------------------------------
# WINDBASIN — wind-driven homogeneous rotating basin
# ---------------------------------------------------------------------------

def windbasin_config(Lm: int = 101, Mm: int = 52, N: int = 25,
                     dt: float = 300.0, ndtfast: int = 30,
                     dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=0.001, theta_b=0.0,
                                 Tcline=1e16),
        eos=EOSConfig(linear=True, R0=1027.0, T0=20.0, S0=35.0,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=2.0),
        drag=BottomDragConfig(kind="quadratic", rdrg2=3.0e-3),
        bc=BoundaryConfig(),                   # closed basin
        rho0=1025.0, gamma2=1.0, dtype=dtype,
    )


def windbasin_grid(cfg: ModelConfig, device="cuda") -> Grid:
    return _plane_grid(cfg, 2000.0 * cfg.Lm, 1000.0 * cfg.Mm, 50.0,
                       f0=1.0e-4, device=device)


def windbasin_initial(cfg: ModelConfig, grid: Grid) -> State:
    T = torch.full((cfg.N,) + cfg.shape2d, 20.0,
                   dtype=torch_dtype(cfg.dtype), device=grid.device)
    return _with_tracers(cfg, grid, T)


def windbasin_forcing_fn(cfg: ModelConfig, grid: Grid):
    """Westward wind ramped over 2 days, then constant -0.1 N/m2
    (ana_smflux.h:331-340)."""
    def sustr(time, zeros):
        tdays = time / 86400.0
        amp = -0.1 * math.sin(math.pi * tdays / 4.0) if tdays <= 2.0 \
            else -0.1
        return amp / cfg.rho0 + zeros

    return _forcing(cfg, grid, sustr)


# ---------------------------------------------------------------------------
# CHANNEL (channel.h): geostrophically balanced Gaussian jet in a periodic
# f-plane channel (guscale = 40 km, u0 = 1.6 m/s)
# ---------------------------------------------------------------------------

def channel_config(Lm: int = 128, Mm: int = 72, N: int = 10,
                   dt: float = 400.0, ndtfast: int = 20,
                   dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=0.0, theta_b=0.0,
                                 Tcline=1e16),
        eos=EOSConfig(linear=True, R0=1027.0, T0=14.0, S0=35.0,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=100.0, tnu2=(5.0, 5.0)),
        drag=BottomDragConfig(kind="linear", rdrg=3.0e-4),
        bc=BoundaryConfig.uniform(LBC.ew_periodic()),
        rho0=1025.0, gamma2=1.0, dtype=dtype,
    )


def channel_grid(cfg: ModelConfig, device="cuda") -> Grid:
    return _plane_grid(cfg, 600.0e3, 360.0e3, 500.0, f0=1.0e-4,
                       device=device)


def channel_initial(cfg: ModelConfig, grid: Grid) -> State:
    """u = u0 exp(-((y - y0)/guscale)^2)/6 in geostrophic balance with
    zeta (ana_initial.h:218-230, 349-367), from the grid's own yr and f
    on the host (scipy's erf)."""
    from scipy.special import erf
    Mj, Li = cfg.shape2d
    guscale, u0 = 40.0e3, 1.6
    y0 = 0.5 * 360.0e3
    yr = grid.yr.cpu().numpy()
    f = grid.f.cpu().numpy()
    val = (yr - y0) / guscale
    u2d = u0 * np.exp(-val * val) / 6.0
    zeta = (-u0 * guscale * f * np.sqrt(np.pi) / (12.0 * cfg.g)
            * erf(val))
    u3 = _tensor(cfg, grid, np.broadcast_to(u2d, (cfg.N, Mj, Li)).copy())
    T = torch.full((cfg.N, Mj, Li), 14.0, dtype=torch_dtype(cfg.dtype),
                   device=grid.device)
    return _with_tracers(cfg, grid, T, zeta=_tensor(cfg, grid, zeta),
                         u=u3)


def channel_forcing_fn(cfg: ModelConfig, grid: Grid):
    return zero_forcing(cfg, grid)


# ---------------------------------------------------------------------------
# LAKE_SIGNELL — wind-driven closed lake with GLS mixing and log drag
# (lake_signell.h; its SSW wave-current BBL and sediment are not in
# roms_tpu's configuration either)
# ---------------------------------------------------------------------------

def lake_signell_config(Lm: int = 100, Mm: int = 20, N: int = 8,
                        dt: float = 60.0, ndtfast: int = 20,
                        dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=1.0, theta_b=1.0, Tcline=20.0),
        eos=EOSConfig(linear=True, R0=1027.0, T0=10.0, S0=30.0,
                      Tcoef=1.7e-4, Scoef=7.6e-4),
        mixing=MixingConfig(vmix="gls", akv_bak=5.0e-6,
                            akt_bak=(5.0e-6, 5.0e-6)),
        drag=BottomDragConfig(kind="log", Zob=0.005),
        bc=BoundaryConfig(),                   # closed basin
        rho0=1025.0, gamma2=1.0, dtype=dtype,
    )


def lake_signell_grid(cfg: ModelConfig, device="cuda") -> Grid:
    """2 m at the south shore deepening to 18 m at the north one."""
    Mm = cfg.Mm

    def h2d(xr, yr):
        dy = 10.0e3 / Mm
        j = yr / dy + 0.5                       # the j index
        return 18.0 - 16.0 * (Mm - j) / (Mm - 1.0)

    return _plane_grid(cfg, 50.0e3, 10.0e3, 18.0, f0=0.0, h2d=h2d,
                       device=device)


def lake_signell_initial(cfg: ModelConfig, grid: Grid) -> State:
    Mj, Li = cfg.shape2d
    T = torch.full((cfg.N, Mj, Li), 10.0, dtype=torch_dtype(cfg.dtype),
                   device=grid.device)
    S = torch.full_like(T, 30.0)
    return initial_state(cfg, grid, t=torch.stack([T, S]))


def lake_signell_forcing_fn(cfg: ModelConfig, grid: Grid):
    """0.25 N/m2 along-lake wind, tanh ramp up at hour 15 over 10 h and
    down at hour 50 (ana_smflux.h:219-231)."""
    mxst, ramp_u, ramp_time, ramp_d = 0.25, 15.0, 10.0, 50.0

    def sustr(time, zeros):
        th = time / 3600.0
        up = 0.5 * (math.tanh((th - ramp_u) / (ramp_time / 5.0)) + 1.0)
        dn = 1.0 - 0.5 * (math.tanh((th - ramp_d) / (ramp_time / 5.0))
                          + 1.0)
        return (mxst / cfg.rho0 * min(up, dn)) + zeros

    return _forcing(cfg, grid, sustr)


# ---------------------------------------------------------------------------
# LMD_TEST — doubly periodic KPP mixed-layer deepening under a wind pulse
# ---------------------------------------------------------------------------

def lmd_test_config(Lm: int = 10, Mm: int = 10, N: int = 50,
                    dt: float = 300.0, ndtfast: int = 30,
                    dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=3.0, theta_b=0.0, Tcline=50.0),
        eos=EOSConfig(),                       # NONLIN_EOS
        mixing=MixingConfig(vmix="lmd", bkpp=True),
        drag=BottomDragConfig(kind="quadratic", rdrg2=3.0e-3),
        bc=BoundaryConfig.uniform(LBC.same(PERIODIC)),
        rho0=1025.0, gamma2=1.0, dtype=dtype,
    )


def lmd_test_grid(cfg: ModelConfig, device="cuda") -> Grid:
    return _plane_grid(cfg, 100.0e3, 100.0e3, 50.0, f0=1.09e-4,
                       device=device)


def lmd_test_initial(cfg: ModelConfig, grid: Grid) -> State:
    """T = min(13, 7 + 0.2 (z + 50)), S = 35 (ana_initial.h:719-730)."""
    T = torch.clamp(7.0 + 0.2 * (_z_r0(cfg, grid) + 50.0), max=13.0)
    S = torch.full_like(T, 35.0)
    return initial_state(cfg, grid, t=torch.stack([T, S]))


def lmd_test_forcing_fn(cfg: ModelConfig, grid: Grid):
    """16-hour wind pulse -0.6 sin(pi t/T) sin(2 pi t/T) N/m2
    (ana_smflux.h:236-250)."""
    def sustr(time, zeros):
        amp = -0.6 * math.sin(math.pi * time / 57600.0) \
            * math.sin(2.0 * math.pi * time / 57600.0) / cfg.rho0 \
            if time <= 57600.0 else 0.0
        return amp + zeros

    return _forcing(cfg, grid, sustr)


# ---------------------------------------------------------------------------
# MIXED_LAYER — doubly periodic GLS surface mixed layer with log drag
# ---------------------------------------------------------------------------

def mixed_layer_config(Lm: int = 5, Mm: int = 4, N: int = 30,
                       dt: float = 30.0, ndtfast: int = 10,
                       dtype: str = "float64") -> ModelConfig:
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=0.001, theta_b=0.0,
                                 Tcline=1e16),
        eos=EOSConfig(linear=True, R0=1027.0, T0=10.0, S0=35.0,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(vmix="gls"),
        drag=BottomDragConfig(kind="log", Zob=0.02),
        bc=BoundaryConfig.uniform(LBC.same(PERIODIC)),
        rho0=1025.0, gamma2=1.0, uv_cor=False, dtype=dtype,
    )


def mixed_layer_grid(cfg: ModelConfig, device="cuda") -> Grid:
    return _plane_grid(cfg, 500.0, 400.0, 50.0, f0=0.0, device=device)


def mixed_layer_initial(cfg: ModelConfig, grid: Grid) -> State:
    """T = 10 + 3 (z + h)/h (ana_initial.h:731-742)."""
    T = 10.0 + 3.0 * (_z_r0(cfg, grid) + grid.h[None]) / grid.h[None]
    return _with_tracers(cfg, grid, T)


def mixed_layer_forcing_fn(cfg: ModelConfig, grid: Grid):
    """Constant 1e-4 m2/s2 kinematic wind stress (ana_smflux.h:189)."""
    return _forcing(cfg, grid, lambda time, zeros: zeros + 1.0e-4)


# ---------------------------------------------------------------------------
# LAB_CANYON (lab_canyon.h): rotating-table polar annulus with a
# shelf-break canyon; curvilinear metrics with variable azimuthal spacing
# ---------------------------------------------------------------------------

def lab_canyon_config(Lm: int = 48, Mm: int = 72, N: int = 10,
                      dt: float = 0.05, ndtfast: int = 10,
                      dtype: str = "float64") -> ModelConfig:
    lbc = LBC(west=CLOSED, east=CLOSED, south=PERIODIC, north=PERIODIC)
    return ModelConfig(
        Lm=Lm, Mm=Mm, NT=2, NAT=2, dt=dt, ndtfast=ndtfast,
        vert=VerticalCoordConfig(N=N, Vtransform=1, Vstretching=1,
                                 theta_s=0.0, theta_b=0.0,
                                 Tcline=1e16),
        eos=EOSConfig(linear=True, R0=1027.0, T0=14.0, S0=35.0,
                      Tcoef=1.7e-4, Scoef=0.0),
        mixing=MixingConfig(visc2=1.0e-5, tnu2=(1.0e-6, 1.0e-6),
                            mix_geo_ts=True),
        drag=BottomDragConfig(kind="linear", rdrg=3.0e-4),
        bc=BoundaryConfig.uniform(lbc),
        rho0=1025.0, gamma2=1.0, curvgrid=True, dtype=dtype,
    )


def lab_canyon_grid(cfg: ModelConfig, device="cuda") -> Grid:
    """Polar annulus r in [0.35, 0.90] m with variable azimuthal spacing
    and the canyon notch in the shelf break (ana_grid.h:483-514,
    960-991); the curvature terms from the metrics (dndx = dmde = None)."""
    Lm, Mm = cfg.Lm, cfg.Mm
    Mj, Li = cfg.shape2d
    Xsize = 0.55
    dx = Xsize / Lm
    dth = 0.01
    twopi = 2.0 * np.pi
    cffF = (4.0 * np.pi / (dth * Mm)) - 1.0

    jj = np.arange(Mj, dtype=np.float64)[:, None]
    ii = np.arange(Li, dtype=np.float64)[None, :]
    # rho points (i-1+0.5, j-1+0.5) in the reference's 1-based layout
    r = 0.35 + dx * (ii - 0.5)
    theta = -np.pi + 0.5 * dth * (
        (cffF + 1.0) * (jj - 0.5)
        + (cffF - 1.0) * (Mm / twopi) * np.sin(twopi * (jj - 0.5) / Mm))
    xr = r * np.cos(theta) + 0.0 * jj
    yr = r * np.sin(theta) + 0.0 * ii
    # metrics: pm = 1/dr, pn = 1/(r dtheta_j)
    dth_j = 0.5 * dth * ((cffF + 1.0)
                         + (cffF - 1.0) * np.cos(twopi * (jj - 0.5) / Mm))
    pm = np.broadcast_to(1.0 / dx, (Mj, Li)).copy()
    pn = 1.0 / (r * dth_j) + 0.0 * jj
    angler = np.broadcast_to(theta, (Mj, Li)).copy()

    # bathymetry: shelf 0.025 m, deep 0.125 m, the canyon notch where
    # |theta| < 2/11
    val1 = 0.55 - 0.15 * np.cos(np.pi * theta * 0.55 / 0.2) ** 2
    val2 = 0.15 + 0.15 * np.cos(np.pi * theta * 0.55 / 0.2) ** 2
    r2 = np.broadcast_to(r, (Mj, Li))
    th2 = np.broadcast_to(theta, (Mj, Li))
    v1 = np.broadcast_to(val1, (Mj, Li))
    v2 = np.broadcast_to(val2, (Mj, Li))
    h_out = np.where(r2 <= 0.55, 0.025,
                     np.where(r2 >= 0.7, 0.125,
                              0.125 - 0.1 * np.cos(
                                  0.5 * np.pi * (r2 - 0.55) / 0.15) ** 2))
    h_in = np.where(r2 <= v1, 0.025,
                    np.where(r2 >= 0.7, 0.125,
                             0.125 - 0.1 * np.cos(
                                 0.5 * np.pi * (r2 - v1)
                                 / np.maximum(v2, 1e-9)) ** 2))
    h = np.where(np.abs(th2) >= 0.181818181818, h_out, h_in)

    f0 = 4.0 * np.pi / 25.0
    return build_grid(cfg, h=h, pm=pm,
                      pn=np.broadcast_to(pn, (Mj, Li)).copy(),
                      f=np.full((Mj, Li), f0), xr=xr, yr=yr,
                      angler=angler, dndx=None, dmde=None, device=device)


def lab_canyon_initial(cfg: ModelConfig, grid: Grid) -> State:
    T = torch.full((cfg.N,) + cfg.shape2d, 14.0,
                   dtype=torch_dtype(cfg.dtype), device=grid.device)
    return _with_tracers(cfg, grid, T)
