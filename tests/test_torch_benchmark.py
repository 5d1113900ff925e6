"""Slice 3 of roms_tpu_torch, the BENCHMARK full-physics channel, against
roms_tpu on the CPU: float64, inputs from a numpy seed on a small
BENCHMARK grid (Lm=16, Mm=6, N=6: Mj=8 is one Pallas block), zonally
varying so that errors at the periodic seam cannot cancel.

- kernels 13-16 (COARE bulk fluxes, LMD-KPP, EOS + KPP, the rotated
  geopotential tracer mixing): each plain version, which is what its
  wrapper runs on CPU tensors, against the Pallas kernel run as
  roms_tpu's own tests run it (interpret=True), relative 1e-12, and
  against roms_tpu's jnp functions;
- the modules around them: the LMD helpers, quadratic drag, the
  solar-source and nonlocal seeds of pre_step3d, the harmonic and
  biharmonic geopotential mixing, the analytic atmosphere and the
  functionals;
- 5 BENCHMARK full-physics steps of the port against roms_tpu with its
  prep, bulk and hmix kernels in interpret mode (and 5 steps of the light
  variant), within the cross-engine bound 1e-10*max|x| + 5e-14.

The CUDA kernels themselves need a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.config import LBC, BoundaryConfig
from roms_tpu.core import bulk_flux as jbulk, hmix, lmd, set_vbc, stepping
from roms_tpu.core.omega import omega
from roms_tpu.core.pre_step3d import pre_step3d
from roms_tpu.core.rho_eos import rho_eos
from roms_tpu.core.state import Forcing
from roms_tpu.functionals import benchmark as bm
from roms_tpu.grid.depth import set_depth, set_massflux
from roms_tpu.ops import (pallas_bulk, pallas_hmix, pallas_kpp, pallas_prep,
                          stencil as st)
from roms_tpu_torch.core import bulk_flux as tbulk_core, hmix as thmix
from roms_tpu_torch.core import lmd as tlmd, set_vbc as tset_vbc
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.core.pre_step3d import pre_step3d as tpre_step3d
from roms_tpu_torch.core.state import Forcing as TForcing
from roms_tpu_torch.functionals import benchmark as tbm
from roms_tpu_torch.ops import bulk as tbulk, hmix as thmix_op
from roms_tpu_torch.ops import kpp as tkpp, prep as tprep

from roms_tpu_torch import convert

from torch_port_util import cfg_dict, port, reference_run, rel_err, t2n
from torch_port_util import xla_fast_compiles  # noqa: F401

TOL = 1e-12
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")
ATM = ("Uwind", "Vwind", "Tair", "Pair", "Hair", "cloud", "rain", "srflx")
# roms_tpu's BENCHMARK kernels in interpret mode on the CPU
FLAGS = ("ROMS_TPU_PALLAS_PREP", "ROMS_TPU_PALLAS_KPP",
         "ROMS_TPU_PALLAS_KPP_INTERPRET", "ROMS_TPU_PALLAS_HMIX",
         "ROMS_TPU_PALLAS_HMIX_INTERPRET")


def _t(x):
    if isinstance(x, (list, tuple)):
        return [_t(y) for y in x]
    return torch.from_numpy(np.array(x))


def _jit(fn, *args):
    """roms_tpu's function compiled once (eager JAX compiles op by op)."""
    return jax.jit(fn)(*args)


def _atm_pair(cls_j, cls_t, fields):
    return (cls_j(**{k: jnp.asarray(v) for k, v in fields.items()}),
            cls_t(**{k: _t(v) for k, v in fields.items()}))


@pytest.fixture(scope="module")
def bc():
    """BENCHMARK full physics at Lm=16, Mm=6, N=6 with seeded, zonally
    varying fields (periodic lanes hold their copies) and a seeded
    atmosphere: winds of both signs, nonzero Vwind and rain, air
    temperatures on both sides of the SST, relative and specific
    humidity.  JAX arrays plus the config/grid of both packages."""
    torch.set_num_threads(1)
    cfg = bm.make_config(Lm=16, Mm=6, N=6, dtype="float64",
                         full_physics=True)
    grid = bm.make_grid(cfg)
    s = bm.make_initial(cfg, grid)
    rng = np.random.default_rng(2026)
    N, (Mj, Li), NT = cfg.N, cfg.shape2d, cfg.NT

    def r(*shape, scale=1.0):
        return st.periodic_x(jnp.asarray(scale * rng.standard_normal(shape)))

    z_r, z_w, Hz = set_depth(grid, r(Mj, Li, scale=0.05))
    u = r(N, Mj, Li, scale=0.1) * grid.umask
    v = r(N, Mj, Li, scale=0.1) * grid.vmask
    t = s.t + r(NT, N, Mj, Li, scale=0.1)
    rho, pden, _, _, bvf = _jit(lambda *x: rho_eos(cfg, *x), t, z_r, Hz,
                                z_w)
    sst, sss = t[0][-1], t[1][-1]
    hair = np.clip(0.8 + 0.1 * rng.standard_normal((Mj, Li)), 0.3, 1.0)
    hair[rng.random((Mj, Li)) < 0.25] = 12.0        # g/kg
    atm = dict(
        Uwind=10.0 * rng.standard_normal((Mj, Li)),
        Vwind=5.0 * rng.standard_normal((Mj, Li)),
        Tair=np.asarray(sst) + 2.0 * rng.standard_normal((Mj, Li)),
        Pair=1013.0 + 10.0 * rng.standard_normal((Mj, Li)),
        Hair=hair,
        cloud=np.clip(0.5 + 0.2 * rng.standard_normal((Mj, Li)), 0.0, 1.0),
        rain=1e-4 * np.abs(rng.standard_normal((Mj, Li))),
        srflx=2e-4 * np.abs(rng.standard_normal((Mj, Li))))
    jatm, tatm = _atm_pair(jbulk.AtmState, tbulk_core.AtmState, atm)
    sustr, svstr, stT, stS, *_ = jbulk.bulk_flux(cfg, jatm, sst, sss,
                                                 rho[-1])
    zeros = jnp.zeros_like(stT)
    forcing = Forcing(sustr=sustr, svstr=svstr,
                      stflx=jnp.stack([stT, stS]),
                      btflx=jnp.stack([zeros, zeros]), srflx=jatm.srflx)
    a = dict(z_r=z_r, z_w=z_w, Hz=Hz, u=u, v=v, t=t, rho=rho, pden=pden,
             bvf=bvf, sst=sst, sss=sss, forcing=forcing)
    tcfg, tgrid = port(cfg, grid)
    return cfg, grid, tcfg, tgrid, a, jatm, tatm, rng


def _tforcing(f):
    return TForcing(*_t(list(f)))


# --------------------------------------------------------------------------
# LMD helpers and kernel 13, the bulk fluxes
# --------------------------------------------------------------------------

def test_lmd_helpers(bc):
    cfg, _, tcfg, _, a, *_ = bc
    depth = -a["z_w"]
    for jw in (1, 5):
        assert rel_err(lmd.swdk_frac(depth, jw),
                       tlmd.swdk_frac(_t(depth), jw)) < TOL
    Ustar = jnp.abs(a["u"][-1]) + 0.01
    zetahat = 1e-7 * a["v"] / 0.1
    ref = _jit(lambda *x: lmd._wscale(*x, 0.41), Ustar[None], zetahat)
    got = tlmd._wscale(_t(Ustar)[None], _t(zetahat), 0.41)
    for r_, g in zip(ref, got):
        assert rel_err(r_, g) < TOL
    # JM95 expansion coefficients: roms_tpu's jax.jvp against the port's
    # written-out derivatives
    for r_, g in zip(_jit(lambda t: lmd._alpha_beta(cfg, t), a["t"]),
                     tlmd._alpha_beta(tcfg, _t(a["t"]))):
        assert rel_err(r_, g) < TOL


@pytest.mark.parametrize("variant", ["coare30", "coare35", "cool_skin"])
def test_bulk_flux_plain(bc, variant):
    cfg, _, tcfg, _, a, jatm, tatm, _ = bc
    kw = dict(coare35=variant == "coare35", cool_skin=variant == "cool_skin")
    args = [a["sst"], a["sss"], a["rho"][-1]]
    got = tbulk.bulk_flux(tcfg, tatm, *_t(args), **kw)
    assert len(got) == 4
    if variant == "coare30":
        # the Pallas kernel on BENCHMARK's variant
        pal = pallas_bulk.bulk_flux_pallas(cfg, jatm, *args, interpret=True,
                                           **kw)
        for r_, g in zip(pal, got):
            assert rel_err(r_, g) < TOL
    ref = jbulk.bulk_flux(cfg, jatm, *args, **kw)
    for r_, g in zip(ref[:4], got):
        assert rel_err(r_, g) < TOL
    # the elementwise core, diagnostics included
    for r_, g in zip(jbulk.bulk_flux_rho(cfg, jatm, *args, **kw),
                     tbulk_core.bulk_flux_rho(tcfg, tatm, *_t(args), **kw)):
        assert rel_err(r_, g) < TOL


def test_bulk_inputs_cover_both_regimes(bc):
    """The seeded atmosphere drives stable and unstable surface layers
    and both humidity branches."""
    _, _, _, _, a, jatm, *_ = bc
    dT = np.asarray(a["sst"] - jatm.Tair)
    assert (dT > 0).any() and (dT < 0).any()
    assert (np.asarray(jatm.Hair) >= 2.0).any()
    assert (np.asarray(jatm.Uwind) < 0).any() and (
        np.asarray(jatm.Uwind) > 0).any()


# --------------------------------------------------------------------------
# kernels 14 and 15, the KPP column alone and after the EOS
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kc(bc):
    """The 2-D inputs of the column closure from the port's surface
    forcing, with seeded surface buoyancy fluxes of both signs and
    friction velocities (some zero), so that Bfsfc takes both signs and
    the Ekman/Monin-Obukhov cap acts in some columns."""
    cfg, grid, tcfg, tgrid, a, _, _, rng = bc
    planes = tkpp.surface_forcing(tcfg, tgrid, _t(a["t"]), _t(a["u"]),
                                  _t(a["v"]), _tforcing(a["forcing"]))
    planes = [t2n(x) for x in planes]
    Mj, Li = cfg.shape2d
    ustar = 0.01 * np.abs(rng.standard_normal((Mj, Li)))
    ustar[rng.random((Mj, Li)) < 0.1] = 0.0
    planes[2] = ustar
    planes[3] = 3e-8 * rng.standard_normal((Mj, Li))          # Bo
    planes[4] = 1e-8 * np.abs(rng.standard_normal((Mj, Li)))  # Bosol
    # statically unstable columns, where no critical Richardson number
    # is crossed (KPP mode only: prep makes its own density)
    flip = np.where(rng.random((Mj, Li)) < 0.3, -1.0, 1.0)
    cols = [a["pden"] * flip, a["bvf"] * flip]
    return [jnp.asarray(x) for x in planes], cols


def _kpp_args(a, kc):
    (u_r, v_r, *p2), (pden, bvf) = kc
    return [u_r, v_r, pden, bvf, a["Hz"], a["z_w"]] + p2


def test_kpp_plain(bc, kc):
    cfg, _, tcfg, _, a, *_ = bc
    args = _kpp_args(a, kc)
    got = tkpp.kpp(tcfg, *_t(args))
    ref = pallas_kpp.kpp_pallas(cfg, *args, jwtype=cfg.mixing.jwtype,
                                interpret=True)
    assert len(got) == len(ref) == 5
    for r_, g in zip(ref, got):
        assert rel_err(r_, g) < TOL
    # the seeded columns reach every branch of the boundary-layer depth
    hsbl, z_w = t2n(got[4]), np.asarray(a["z_w"])
    assert (hsbl == z_w[1]).any() and (hsbl != z_w[1]).any()
    assert (np.asarray(args[7]) > 0).any() and (np.asarray(args[7]) < 0).any()


def test_lmd_kpp_fused_plain(bc):
    """The wrapper with its 2-D preparation (Ustar, alpha/beta, Bo, the
    rho-point velocities) against the Pallas wrapper and against
    roms_tpu's jnp route lmd_vmix_interior + lmd_skpp, the latter at the
    tolerances of roms_tpu's own test (tests/test_pallas_kpp.py)."""
    cfg, grid, tcfg, tgrid, a, *_ = bc
    args = [a[k] for k in ("t", "u", "v", "pden", "bvf", "Hz", "z_r",
                           "z_w")]
    got = tkpp.lmd_kpp_fused(tcfg, tgrid, *_t(args),
                             _tforcing(a["forcing"]))
    pal = _jit(lambda *x: pallas_kpp.lmd_kpp_fused(cfg, grid, *x,
                                                   interpret=True),
               *args, a["forcing"])
    for r_, g in zip(pal, got):
        assert rel_err(r_, g) < TOL

    def jnp_route(t, u, v, pden, bvf, Hz, z_r, z_w, forcing):
        Akv, Akt = lmd.lmd_vmix_interior(cfg, u, v, bvf, Hz)
        return lmd.lmd_skpp(cfg, grid, t, u, v, pden, bvf, Hz, z_r, z_w,
                            forcing, Akv, Akt)

    ref = _jit(jnp_route, *args, a["forcing"])
    Akv_g, Akt_g, gh_g, hsbl_g = (t2n(x) for x in got)
    np.testing.assert_allclose(hsbl_g, np.asarray(ref[3]), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(Akv_g, np.asarray(ref[0]), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(Akt_g[0], np.asarray(ref[1][0]), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(gh_g, np.asarray(ref[2]), rtol=1e-8,
                               atol=1e-15)


def test_prep_plain(bc, kc):
    cfg, grid, tcfg, tgrid, a, *_ = bc
    args = [a[k] for k in ("t", "z_r", "Hz", "z_w")] + kc[0]
    got = tprep.prep(tcfg, *_t(args))
    ref = pallas_prep.prep_pallas(cfg, *args, jwtype=cfg.mixing.jwtype,
                                  interpret=True)
    assert len(got) == len(ref) == 9
    for r_, g in zip(ref, got):
        assert rel_err(r_, g) < TOL
    # the fused wrapper with its own 2-D preparation
    fargs = [a[k] for k in ("t", "u", "v", "Hz", "z_r", "z_w")]
    got = tprep.prep_fused(tcfg, tgrid, *_t(fargs), _tforcing(a["forcing"]))
    ref = pallas_prep.prep_fused(cfg, grid, *fargs, a["forcing"],
                                 interpret=True)
    for r_, g in zip(ref, got):
        assert rel_err(r_, g) < TOL


@pytest.mark.parametrize("linear", [False, True], ids=["jm95", "linear"])
def test_surface_rho(bc, linear):
    cfg, _, tcfg, _, a, *_ = bc
    if linear:
        cfg = cfg.replace(eos=cfg.eos.__class__(linear=True))
        tcfg = tcfg.replace(eos=tcfg.eos.__class__(linear=True))
    ref = pallas_prep.surface_rho(cfg, a["t"], a["z_r"])
    got = tprep.surface_rho(tcfg, *_t([a["t"], a["z_r"]]))
    assert rel_err(ref, got) < TOL
    # the top level of the column EOS
    assert rel_err(rho_eos(cfg, a["t"], a["z_r"], a["Hz"], a["z_w"])[0][-1],
                   got) < TOL


# --------------------------------------------------------------------------
# kernel 16, the rotated geopotential tracer mixing
# --------------------------------------------------------------------------

def _closed(cfg):
    return cfg.replace(bc=BoundaryConfig.uniform(LBC()))


@pytest.mark.parametrize("ew", [True, False], ids=["ew_periodic", "closed"])
def test_rot_div_geo_plain(bc, ew):
    cfg, grid, tcfg, tgrid, a, *_ = bc
    if not ew:
        cfg = _closed(cfg)
        tcfg = convert.config_from_dict(cfg_dict(cfg))
    q, Hz, z_r = a["t"], a["Hz"], a["z_r"]
    d2s = grid.diff2
    got = thmix_op.rot_div_geo(tcfg, tgrid, *_t([q, d2s, Hz, z_r]))
    # the Pallas kernel zeroes the ring rows, the jnp path wraps there
    pal = pallas_hmix.rot_div_geo_batched(cfg, grid, q, list(d2s), Hz, z_r,
                                          interpret=True)
    assert rel_err(pal, got, np.s_[..., 1:-1, :]) < TOL
    pm_u = 0.5 * (grid.pm + st.im1(grid.pm)) * grid.umask
    pn_v = 0.5 * (grid.pn + st.jm1(grid.pn)) * grid.vmask
    dZdx = pm_u * (z_r - st.im1(z_r))
    dZde = pn_v * (z_r - st.jm1(z_r))
    if ew:
        dZdx = st.periodic_x(dZdx)
    ref = jnp.stack([hmix._rot_div_geo(cfg, grid, q[i], d2s[i], Hz, z_r,
                                       dZdx, dZde) for i in range(cfg.NT)])
    assert rel_err(ref, got) < TOL
    # the single-tracer entry point
    d2 = 250.0 * jnp.ones_like(grid.pm)
    one = thmix_op.rot_div_geo_single(tcfg, tgrid, _t(q[1]), _t(d2),
                                      *_t([Hz, z_r]))
    pal1 = pallas_hmix.rot_div_geo_pallas(cfg, grid, q[1], d2, Hz, z_r,
                                          interpret=True)
    assert rel_err(pal1, one, np.s_[..., 1:-1, :]) < TOL


@pytest.fixture(scope="module")
def geo4(bc):
    """The configuration with biharmonic geopotential mixing on
    (tnu4 > 0, as BENCHMARK's deck allows), both packages."""
    cfg = bc[0]
    cfg4 = cfg.replace(mixing=cfg.mixing.__class__(
        **{**cfg.mixing.__dict__, "tnu4": (2.0e9, 1.0e9)}))
    grid4 = bm.make_grid(cfg4)
    return (cfg4, grid4) + port(cfg4, grid4)


@pytest.mark.parametrize("route", ["jnp", "pallas"])
def test_t3dmix_geo(bc, geo4, monkeypatch, route):
    """t3dmix2_geo and t3dmix4_geo (tnu4 > 0) against roms_tpu's jnp
    route over whole arrays and its Pallas route over the interior
    rows."""
    a = bc[4]
    cfg, grid, tcfg, tgrid = geo4
    if route == "pallas":
        monkeypatch.setenv("ROMS_TPU_PALLAS_HMIX", "1")
        monkeypatch.setenv("ROMS_TPU_PALLAS_HMIX_INTERPRET", "1")
        sl = np.s_[..., 1:-1, :]
    else:
        monkeypatch.setenv("ROMS_TPU_PALLAS_HMIX", "0")
        sl = np.s_[...]
    t, Hz, z_r = a["t"], a["Hz"], a["z_r"]
    t_part = Hz[None] * t
    targs = _t([t, t_part, Hz, z_r])
    for jfn, tfn in ((hmix.t3dmix2_geo, thmix.t3dmix2_geo),
                     (hmix.t3dmix4_geo, thmix.t3dmix4_geo)):
        ref = jfn(cfg, grid, t, t_part, Hz, z_r)
        got = tfn(tcfg, tgrid, *targs)
        assert rel_err(ref - t_part, got - targs[1], sl) < 1e-11
        assert rel_err(ref, got, sl) < TOL


# --------------------------------------------------------------------------
# drag, seeds, atmosphere, functionals
# --------------------------------------------------------------------------

def test_quadratic_drag(bc):
    cfg, grid, tcfg, tgrid, a, *_ = bc
    assert cfg.drag.kind == "quadratic"
    args = [a[k] for k in ("u", "v", "Hz", "z_r", "z_w")]
    ref = set_vbc.bottom_drag(cfg, grid, *args)
    got = tset_vbc.bottom_drag(tcfg, tgrid, *_t(args))
    for r_, g in zip(ref, got):
        assert rel_err(r_, g) < TOL


@pytest.mark.parametrize("iic", [0, 2])
def test_solar_and_nonlocal_seeds(bc, iic):
    """pre_step3d with SOLAR_SOURCE (penetrating shortwave at interior
    interfaces) and the LMD_NONLOCAL flux Akt*ghats."""
    cfg, grid, tcfg, tgrid, a, _, _, rng = bc
    assert cfg.mixing.solar_source
    N, (Mj, Li), NT = cfg.N, cfg.shape2d, cfg.NT
    Huon, Hvom = set_massflux(grid, a["u"], a["v"], a["Hz"])
    Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    W = omega(cfg, grid, Huon, Hvom, a["z_w"])

    def r(*shape, scale=1.0):
        return jnp.asarray(scale * rng.standard_normal(shape))

    ghats = r(cfg.NAT, N + 1, Mj, Li, scale=1e-6)
    bustr, bvstr = r(Mj, Li, scale=1e-5), r(Mj, Li, scale=1e-5)
    args = [a["u"], a["v"], a["t"], a["t"] + r(NT, N, Mj, Li, scale=0.01),
            r(N, Mj, Li), r(N, Mj, Li), r(N, Mj, Li), r(N, Mj, Li),
            a["Hz"], a["z_r"], a["z_w"], Huon, Hvom, W]
    ref = pre_step3d(cfg, grid, *args, a["forcing"], bustr, bvstr, iic,
                     ghats=ghats)
    got = tpre_step3d(tcfg, tgrid, *_t(args), _tforcing(a["forcing"]),
                      *_t([bustr, bvstr]), iic, ghats=_t(ghats))
    for r_, g in zip(ref[1:], got[1:]):
        assert rel_err(r_, g) < TOL
    assert rel_err(ref[0], got[0], np.s_[..., 1:-1, :]) < TOL


@pytest.fixture(scope="module")
def func_pair():
    cfg = bm.make_config(Lm=16, Mm=6, N=6, dtype="float64",
                         full_physics=True)
    grid = bm.make_grid(cfg)
    tcfg = tbm.make_config(Lm=16, Mm=6, N=6, dtype="float64",
                           full_physics=True)
    return cfg, grid, tcfg, tbm.make_grid(tcfg, device="cpu")


@pytest.mark.parametrize("time", [0.0, 40.3 * 86400.0],
                         ids=["jan1_midnight", "feb10_morning"])
def test_make_atm_fn(func_pair, time):
    """The analytic atmosphere at two clock times: both have part of the
    channel in daylight."""
    cfg, grid, tcfg, tgrid = func_pair
    ref = bm.make_atm_fn(cfg, grid)(time)
    got = tbm.make_atm_fn(tcfg, tgrid)(time)
    for name in ATM:
        assert rel_err(getattr(ref, name), getattr(got, name)) < TOL, name
    sr = t2n(got.srflx)
    assert (sr > 0).any() and (sr == 0).any()


def test_port_functionals_match_roms_tpu(func_pair):
    """The port's own BENCHMARK config, grid, initial state and forcing
    functions equal roms_tpu's."""
    cfg, grid, tcfg, g = func_pair
    assert cfg_dict(cfg) == cfg_dict(tcfg)
    for name in ("h", "pm", "pn", "f", "xr", "yr", "on_u", "om_v", "diff2",
                 "Cs_r"):
        assert rel_err(getattr(grid, name), getattr(g, name)) < TOL, name
    s, ts = bm.make_initial(cfg, grid), tbm.make_initial(tcfg, g)
    for name in ("t", "z_r", "z_w", "Hz"):
        assert rel_err(getattr(s, name), getattr(ts, name)) < TOL
    lcfg = bm.make_config(Lm=16, Mm=6, N=6, dtype="float64")
    ltcfg = tbm.make_config(Lm=16, Mm=6, N=6, dtype="float64")
    assert rel_err(bm.make_forcing_fn(lcfg, grid)(0.0).sustr,
                   tbm.make_forcing_fn(ltcfg, g)(0.0).sustr) < TOL
    # the bulk forcing: the Model's use_kernels picks the route
    fr = bm.make_bulk_forcing_fn(cfg, grid)(
        3600.0, s.t[0][-1], s.t[1][-1], rho_eos(cfg, s.t, s.z_r, s.Hz,
                                                s.z_w)[0][-1])
    tf = tbm.make_bulk_forcing_fn(tcfg, g)
    args = (3600.0, ts.t[0][-1], ts.t[1][-1],
            tprep.surface_rho(tcfg, ts.t, ts.z_r))
    for kern in (True, False):
        got = tf(*args, use_kernels=kern)
        for r_, x in zip(fr, got):
            assert rel_err(r_, x) < TOL
    # the history writer's diagnosed fields (Model.diagnose): forcing and
    # its bulk components, bottom stress, KPP's AKv/AKt/AKs and Hsbl from
    # the prep route, within the trajectory bound
    ref = stepping.Model(cfg, grid, bm.make_bulk_forcing_fn(
        cfg, grid)).diagnose(s)
    got = tstepping.Model(tcfg, g, tf).diagnose(ts)
    assert sorted(ref) == sorted(got)
    for name, x in ref.items():
        assert rel_err(x, got[name]) < 1e-10, name


def test_benchmark_grid_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbm.make_grid(tbm.make_config(Lm=6, Mm=6, N=4))


# --------------------------------------------------------------------------
# the slice: BENCHMARK trajectories
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["full_physics", "light"])
def runs(request):
    """5 steps of both packages from the analytic initial state plus a
    seeded zonally varying perturbation of u, v and t.  roms_tpu runs its
    BENCHMARK kernels in interpret mode (the flags above; the light
    variant takes only the hmix kernel)."""
    torch.set_num_threads(1)
    full = request.param == "full_physics"
    cfg = bm.make_config(Lm=16, Mm=6, N=6, dtype="float64",
                         full_physics=full)
    grid = bm.make_grid(cfg)
    s0 = bm.make_initial(cfg, grid)
    rng = np.random.default_rng(5)

    def r(shape, scale):
        return st.periodic_x(jnp.asarray(scale * rng.standard_normal(shape)))

    s0 = s0._replace(u=s0.u + r(s0.u.shape, 0.02) * grid.umask,
                     v=s0.v + r(s0.v.shape, 0.02) * grid.vmask,
                     t=s0.t + r(s0.t.shape, 0.1))
    mp = pytest.MonkeyPatch()
    try:
        for flag in FLAGS if full else FLAGS[3:]:
            mp.setenv(flag, "1")
        if full:
            assert pallas_prep.use_pallas_prep(cfg)
        fn = bm.make_bulk_forcing_fn if full else bm.make_forcing_fn
        ref = reference_run(stepping.Model(cfg, grid, fn(cfg, grid)), s0,
                            5)
    finally:
        mp.undo()
    tcfg, tgrid, ts0 = port(cfg, grid, s0)
    tfn = tbm.make_bulk_forcing_fn if full else tbm.make_forcing_fn
    model = tstepping.Model(tcfg, tgrid, tfn(tcfg, tgrid))
    assert model.kpp_route == ("prep" if full else None)
    return ref, model.run(ts0, 5)


@pytest.mark.parametrize("field", FIELDS)
def test_trajectory_matches_roms_tpu(runs, field):
    ref, got = runs
    x = np.asarray(getattr(ref, field))
    y = t2n(getattr(got, field))
    assert np.isfinite(y).all()
    scale = np.abs(x).max() + 1e-30
    assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
        (field, np.abs(y - x).max(), scale)
