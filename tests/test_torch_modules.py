"""The plain PyTorch modules of roms_tpu_torch, one function at a time,
against roms_tpu's jnp functions: float64, numpy-seeded inputs, whole
arrays at 1e-12 relative.  Each runs on the closed DOUBLE_GYRE basin, on
the same grid made EW-periodic (the channel's ring branches) and made
NS-periodic with closed east and west walls (the NS ring branches of the
boundaries, fast loop, omega, RHS terms, advection, pressure gradient
and mixing, which LAB_CANYON's step reaches), with biharmonic mixing
switched on so the t3dmix4/uv3dmix4 paths are exercised."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roms_tpu.config import LBC, BoundaryConfig
from roms_tpu.core import (advection, boundary, hmix, omega, prsgrd,
                           rhs3d, set_vbc)
from roms_tpu.core.pre_step3d import _seeds
from roms_tpu.core.state import Forcing
from roms_tpu.core.step2d import make_fast_loop
from roms_tpu.core.weights import power_law_weights
from roms_tpu.functionals import idealized as ia
from roms_tpu.grid.depth import set_depth, set_massflux
from roms_tpu.ops.tridiag import spline_flux_solve
from roms_tpu_torch.core import advection as t_adv
from roms_tpu_torch.core import boundary as t_bnd
from roms_tpu_torch.core import hmix as t_hmix
from roms_tpu_torch.core import omega as t_omega
from roms_tpu_torch.core import prsgrd as t_prsgrd
from roms_tpu_torch.core import rhs3d as t_rhs3d
from roms_tpu_torch.core import set_vbc as t_vbc
from roms_tpu_torch.core.pre_step3d import _seeds as t_seeds
from roms_tpu_torch.core.state import Forcing as TForcing
from roms_tpu_torch.core.step2d import make_fast_loop as t_make_fast_loop
from roms_tpu_torch.grid import depth as t_depth
from roms_tpu_torch.ops.tridiag import spline_flux_solve as t_spline

from torch_port_util import port, rel_err
from torch_port_util import xla_fast_compiles  # noqa: F401

TOL = 1e-12


def _close(ref, got):
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        if np.abs(r).max() == 0.0:
            assert not torch.as_tensor(g).any()
        else:
            assert rel_err(r, g) < TOL


@pytest.fixture(scope="module", params=["closed", "ew_periodic",
                                        "ns_periodic"])
def mc(request):
    torch.set_num_threads(1)
    cfg = ia.double_gyre_config(Lm=12, Mm=16, N=6, ndtfast=6,
                                dtype="float64")
    cfg = cfg.replace(mixing=cfg.mixing.__class__(
        visc2=800.0, tnu2=(800.0, 500.0), visc4=1.0e9,
        tnu4=(2.0e9, 1.0e9), akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6)))
    if request.param == "ew_periodic":
        cfg = cfg.replace(bc=BoundaryConfig.uniform(LBC.ew_periodic()))
    if request.param == "ns_periodic":
        cfg = cfg.replace(bc=BoundaryConfig.uniform(LBC.ns_periodic()))
    grid = ia.double_gyre_grid(cfg)
    rng = np.random.default_rng(99)
    N, (Mj, Li) = cfg.N, cfg.shape2d

    def r(*shape, scale=1.0):
        return jnp.asarray(scale * rng.standard_normal(shape))

    zeta = r(Mj, Li, scale=0.05)
    z_r, z_w, Hz = set_depth(grid, zeta)
    u, v = r(N, Mj, Li, scale=0.1), r(N, Mj, Li, scale=0.1)
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    a = dict(zeta=zeta, z_r=z_r, z_w=z_w, Hz=Hz, u=u, v=v, Huon=Huon,
             Hvom=Hvom, W=omega.omega(cfg, grid, Huon, Hvom, z_w),
             t=15.0 + r(cfg.NT, N, Mj, Li), rho=r(N, Mj, Li),
             ru=r(N, Mj, Li), rv=r(N, Mj, Li),
             ubar=r(Mj, Li, scale=0.05), vbar=r(Mj, Li, scale=0.05),
             f2=[r(Mj, Li, scale=1e-3) for _ in range(8)])
    tcfg, tgrid = port(cfg, grid)
    t = {k: ([torch.from_numpy(np.array(x)) for x in val]
             if isinstance(val, list) else torch.from_numpy(np.array(val)))
         for k, val in a.items()}
    return cfg, grid, tcfg, tgrid, a, t


def test_set_depth_and_massflux(mc):
    cfg, grid, tcfg, tgrid, a, t = mc
    _close(set_depth(grid, a["zeta"]), t_depth.set_depth(tgrid, t["zeta"]))
    _close(set_massflux(grid, a["u"], a["v"], a["Hz"]),
           t_depth.set_massflux(tgrid, t["u"], t["v"], t["Hz"]))


def test_set_depth_vtransform2():
    from roms_tpu.functionals import upwelling
    cfg = upwelling.make_config(Lm=10, Mm=12, N=5)
    grid = upwelling.make_grid(cfg)
    tcfg, tgrid = port(cfg, grid)
    zeta = np.random.default_rng(1).standard_normal(cfg.shape2d) * 0.1
    _close(set_depth(grid, jnp.asarray(zeta)),
           t_depth.set_depth(tgrid, torch.from_numpy(zeta)))


def test_omega(mc):
    cfg, grid, tcfg, tgrid, a, t = mc
    _close(omega.omega(cfg, grid, a["Huon"], a["Hvom"], a["z_w"]),
           t_omega.omega(tcfg, tgrid, t["Huon"], t["Hvom"], t["z_w"]))


def test_bottom_drag(mc):
    cfg, grid, tcfg, tgrid, a, t = mc
    _close(set_vbc.bottom_drag(cfg, grid, a["u"], a["v"], a["Hz"]),
           t_vbc.bottom_drag(tcfg, tgrid, t["u"], t["v"], t["Hz"]))


def test_prsgrd32(mc):
    cfg, grid, tcfg, tgrid, a, t = mc
    _close(prsgrd.prsgrd32(cfg, grid, a["rho"], a["z_r"], a["z_w"],
                           a["Hz"]),
           t_prsgrd.prsgrd32(tcfg, tgrid, t["rho"], t["z_r"], t["z_w"],
                             t["Hz"]))


@pytest.mark.parametrize("fn", ["t3dmix2_s", "t3dmix4_s"])
def test_tracer_mixing(mc, fn):
    cfg, grid, tcfg, tgrid, a, t = mc
    ref = getattr(hmix, fn)(cfg, grid, a["t"], a["Hz"][None] * a["t"],
                            a["Hz"])
    got = getattr(t_hmix, fn)(tcfg, tgrid, t["t"], t["Hz"][None] * t["t"],
                              t["Hz"])
    _close(ref, got)


@pytest.mark.parametrize("fn", ["uv3dmix2_s", "uv3dmix4_s"])
def test_momentum_mixing(mc, fn):
    cfg, grid, tcfg, tgrid, a, t = mc
    ref = getattr(hmix, fn)(cfg, grid, a["u"], a["v"], a["ru"], a["rv"],
                            a["Hz"], a["f2"][0], a["f2"][1])
    got = getattr(t_hmix, fn)(tcfg, tgrid, t["u"], t["v"], t["ru"],
                              t["rv"], t["Hz"], t["f2"][0], t["f2"][1])
    _close(ref, got)


@pytest.mark.parametrize("scheme", ["upstream3", "centered4"])
def test_tracer_fluxes(mc, scheme):
    cfg, grid, tcfg, tgrid, a, t = mc
    _close(advection.hadv_flux(cfg, grid, a["t"][0], a["Huon"], a["Hvom"],
                               scheme),
           t_adv.hadv_flux(tcfg, tgrid, t["t"][0], t["Huon"], t["Hvom"],
                           scheme))
    if scheme == "centered4":
        _close(advection.vadv_flux(cfg, a["t"][1], a["W"], a["Hz"], scheme),
               t_adv.vadv_flux(tcfg, t["t"][1], t["W"], t["Hz"], scheme))


def test_momentum_rhs_terms(mc):
    cfg, grid, tcfg, tgrid, a, t = mc
    _close(rhs3d.coriolis(cfg, grid, a["u"], a["v"], a["Hz"]),
           t_rhs3d.coriolis(tcfg, tgrid, t["u"], t["v"], t["Hz"]))
    _close(rhs3d.hadv_uv(cfg, grid, a["u"], a["v"], a["Huon"], a["Hvom"]),
           t_rhs3d.hadv_uv(tcfg, tgrid, t["u"], t["v"], t["Huon"],
                           t["Hvom"]))
    _close(rhs3d.vadv_uv(cfg, a["u"], a["v"], a["W"]),
           t_rhs3d.vadv_uv(tcfg, t["u"], t["v"], t["W"]))
    jf = Forcing(*a["f2"][:2], a["t"][:, 0], a["t"][:, 0], a["f2"][2])
    tf = TForcing(*t["f2"][:2], t["t"][:, 0], t["t"][:, 0], t["f2"][2])
    _close(rhs3d.integrate_rufrc(cfg, grid, a["ru"], a["rv"], jf,
                                 a["f2"][3], a["f2"][4]),
           t_rhs3d.integrate_rufrc(tcfg, tgrid, t["ru"], t["rv"], tf,
                                   t["f2"][3], t["f2"][4]))


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_corrector_seeds(mc, iic):
    cfg, grid, tcfg, tgrid, a, t = mc
    jf = Forcing(*a["f2"][:2], 1e-3 * a["t"][:, 0], 1e-3 * a["t"][:, 1],
                 a["f2"][2])
    tf = TForcing(*t["f2"][:2], 1e-3 * t["t"][:, 0], 1e-3 * t["t"][:, 1],
                  t["f2"][2])
    ref = _seeds(cfg, grid, a["u"], a["v"], a["t"], a["ru"], a["rv"],
                 a["rv"], a["ru"], a["Hz"], a["z_w"], jf, a["f2"][3],
                 a["f2"][4], jnp.asarray(iic, jnp.int32), None)
    got = t_seeds(tcfg, tgrid, t["u"], t["v"], t["t"], t["ru"], t["rv"],
                  t["rv"], t["ru"], t["Hz"], t["z_w"], tf, t["f2"][3],
                  t["f2"][4], iic, None)
    _close(ref, got)


@pytest.mark.parametrize("which", ["rho", "u", "v"])
def test_lateral_bcs(mc, which):
    cfg, grid, tcfg, tgrid, a, t = mc
    if which == "rho":
        _close(boundary.bc_rho(a["t"], cfg.bc.t),
               t_bnd.bc_rho(t["t"], tcfg.bc.t))
    else:
        fn = "bc_" + which
        _close(getattr(boundary, fn)(a["u"], cfg.bc.u, cfg.gamma2),
               getattr(t_bnd, fn)(t["u"], tcfg.bc.u, tcfg.gamma2))


def test_spline_flux_solve(mc):
    cfg, grid, tcfg, tgrid, a, t = mc
    Ak = 1e-3 * jnp.abs(a["W"]) + 1e-5
    _close(spline_flux_solve(a["Hz"], Ak, a["u"], cfg.dt),
           t_spline(t["Hz"], 1e-3 * torch.abs(t["W"]) + 1e-5, t["u"],
                    tcfg.dt))


@pytest.fixture(scope="module")
def fast_loops(mc):
    """roms_tpu's fast loop for the fixture's grid, compiled once for
    every iic (a traced argument), beside the weights."""
    cfg = mc[0]
    nfast, w1, w2 = power_law_weights(cfg.ndtfast)
    return jax.jit(make_fast_loop(cfg, nfast, w1, w2)), (nfast, w1, w2)


@pytest.mark.parametrize("iic", [0, 3])
def test_fast_loop(mc, fast_loops, iic):
    cfg, grid, tcfg, tgrid, a, t = mc
    loop, (nfast, w1, w2) = fast_loops
    f2, tf2 = a["f2"], t["f2"]
    rhoS, rhoA = 1e-2 * f2[5], 1e-2 * f2[6]
    ref = loop(
        grid, a["zeta"], a["ubar"], a["vbar"], f2[0], f2[1], rhoS, rhoA,
        f2[2], f2[3], f2[4], f2[7], jnp.asarray(iic, jnp.int32))
    got = t_make_fast_loop(tcfg, nfast, w1, w2)(
        tgrid, t["zeta"], t["ubar"], t["vbar"], tf2[0], tf2[1],
        1e-2 * tf2[5], 1e-2 * tf2[6], tf2[2], tf2[3], tf2[4], tf2[7], iic)
    _close(tuple(ref[0]) + tuple(ref[1:]), tuple(got[0]) + tuple(got[1:]))
