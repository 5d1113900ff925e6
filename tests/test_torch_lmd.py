"""The whole-array LMD route of roms_tpu_torch (LMD_BKPP, LMD_DDMIX) and
the logarithmic bottom drag against roms_tpu on the CPU, float64:

- the route's functions on seeded numpy columns of a doubly periodic
  LMD_TEST grid (Lm=7, Mm=6, N=12, JM95): eos_alpha_beta at the
  interior W interfaces, lmd_vmix_interior, lmd_ddmix (salt fingering and
  diffusive convection both reached), lmd_skpp (crossings found and not,
  stable forcing's cap) and lmd_bkpp (with the surface layer's guard),
  each at 1e-12 relative;
- the logarithmic drag on a grid whose depths put the drag coefficient
  at both clip ends and between them, 1e-12 relative;
- 3 BENCHMARK full-physics steps with LMD_BKPP and LMD_DDMIX (Lm=10,
  Mm=8, N=6) within the bound of tests/test_correctness_gates.py:65,
  1e-10*max|x| + 5e-14, with the route's eight spline solves a step
  reaching kernel 17's wrapper.

The apps this route and the NS-periodic grids unlock are in
tests/test_torch_apps.py, the deck in tests/test_torch_deck.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.core import lmd, set_vbc, stepping
from roms_tpu.core.rho_eos import eos_alpha_beta, rho_eos
from roms_tpu.core.state import Forcing
from roms_tpu.functionals import benchmark as bm, idealized as ia
from roms_tpu.grid.depth import set_depth
from roms_tpu.ops import stencil as st
from roms_tpu_torch.core import lmd as tlmd, set_vbc as tset_vbc
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.core.rho_eos import eos_alpha_beta as teos_alpha_beta
from roms_tpu_torch.core.state import Forcing as TForcing
from roms_tpu_torch.functionals import benchmark as tbm
from roms_tpu_torch.ops import tridiag as ttridiag

from torch_port_util import port, reference_run, rel_err, t2n
from torch_port_util import xla_fast_compiles  # noqa: F401

TOL = 1e-12
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")


def _t(x):
    if isinstance(x, (list, tuple)):
        return [_t(y) for y in x]
    return torch.from_numpy(np.array(x))


def _periodic(x):
    return np.asarray(st.periodic_y(st.periodic_x(jnp.asarray(x))))


@pytest.fixture(scope="module")
def col():
    """(cfg, grid, tcfg, tgrid, a): a holds seeded numpy fields of a
    doubly periodic LMD_TEST grid with LMD_DDMIX on: stratified T and S
    with jumps of both signs (a fifth of the columns statically
    unstable), u and v, surface fluxes of both signs (a sixth of the
    columns without wind), bottom stresses, and the state's pden and bvf
    from roms_tpu's EOS."""
    cfg = ia.lmd_test_config(Lm=7, Mm=6, N=12)
    cfg = cfg.replace(mixing=dataclasses.replace(cfg.mixing, ddmix=True))
    grid = ia.lmd_test_grid(cfg)
    rng = np.random.default_rng(16)
    shp2 = cfg.shape2d
    shp3 = (cfg.N,) + shp2
    zeta = _periodic(0.1 * rng.standard_normal(shp2))
    z_r, z_w, Hz = (np.asarray(x) for x in set_depth(grid, jnp.asarray(
        zeta)))
    flip = np.where(rng.random(shp2) < 0.2, -1.0, 1.0)
    T = 13.0 + flip * 0.12 * z_r + 0.09 * np.cumsum(
        rng.standard_normal(shp3), axis=0)
    S = 35.0 + (0.02 + 0.3 * rng.random(shp2)) * np.cumsum(
        rng.standard_normal(shp3), axis=0)
    a = dict(zeta=zeta, z_r=z_r, z_w=z_w, Hz=Hz,
             t=_periodic(np.stack([T, S])),
             u=_periodic(0.1 * rng.standard_normal(shp3)),
             v=_periodic(0.1 * rng.standard_normal(shp3)))
    calm = rng.random(shp2) < 0.17
    a["forcing"] = dict(
        sustr=_periodic(np.where(calm, 0.0,
                                 2e-4 * rng.standard_normal(shp2))),
        svstr=_periodic(np.where(calm, 0.0,
                                 1e-4 * rng.standard_normal(shp2))),
        stflx=_periodic(np.stack([1e-5 * rng.standard_normal(shp2),
                                  1e-6 * rng.standard_normal(shp2)])),
        btflx=_periodic(np.stack([1e-6 * rng.standard_normal(shp2),
                                  1e-7 * rng.standard_normal(shp2)])),
        srflx=_periodic(2e-5 * np.abs(rng.standard_normal(shp2))))
    a["bustr"] = _periodic(3e-4 * rng.standard_normal(shp2))
    a["bvstr"] = _periodic(3e-4 * rng.standard_normal(shp2))
    _, pden, _, _, bvf = jax.jit(lambda t, zr, hz, zw: rho_eos(
        cfg, t, zr, hz, zw))(a["t"], z_r, Hz, z_w)
    a["pden"], a["bvf"] = np.asarray(pden), np.asarray(bvf)
    tcfg, tgrid = port(cfg, grid)
    return cfg, grid, tcfg, tgrid, a


def _forcings(a):
    f = a["forcing"]
    return (Forcing(**{k: jnp.asarray(v) for k, v in f.items()}),
            TForcing(**{k: _t(v) for k, v in f.items()}))


NAMES = ("t", "u", "v", "pden", "bvf", "Hz", "z_r", "z_w")


@pytest.fixture(scope="module")
def ref(col):
    """roms_tpu's route on the seeded columns, compiled once: alpha,
    beta and alpha/beta at the interior W interfaces from T and S
    averaged there, the interior coefficients,
    LMD_DDMIX's increments on seeded Akt, the surface layer, its level
    and the bottom layer after it."""
    cfg, grid, _, _, a = col
    jf, _ = _forcings(a)
    Akt0 = 1e-5 + 1e-4 * np.abs(np.random.default_rng(6).standard_normal(
        (cfg.NAT, cfg.N + 1) + cfg.shape2d))

    def route(g, f, Akt0, bustr, bvstr, *x):
        t, u, v, pden, bvf, Hz, z_r, z_w = x
        t_i = 0.5 * (t[:, 1:] + t[:, :-1])
        out = dict(aob=eos_alpha_beta(cfg, t_i, z_w[1:-1], all_levels=True))
        out["interior"] = lmd.lmd_vmix_interior(cfg, u, v, bvf, Hz)
        out["ddmix"] = lmd.lmd_ddmix(cfg, t, out["aob"][2], Akt0)
        out["skpp"] = lmd.lmd_skpp(cfg, g, *x, f, *out["interior"])
        hsbl = out["skpp"][3]
        out["ksbl"] = jnp.maximum(jnp.sum(
            (z_w[:-1] < hsbl[None]).astype(jnp.int32), axis=0), 1)
        out["bkpp"] = lmd.lmd_bkpp(cfg, g, *x, f, bustr, bvstr,
                                   *out["skpp"][:2], ksbl_guard=out["ksbl"])
        return out

    out = jax.jit(route)(grid, jf, Akt0, a["bustr"], a["bvstr"],
                         *[a[k] for k in NAMES])
    out = jax.tree_util.tree_map(np.asarray, out)
    out["Akt0"] = Akt0
    return out


def _assert_close(ref, got, tol=TOL):
    for i, (r, g) in enumerate(zip(ref, got)):
        assert rel_err(r, g) < tol, (i, rel_err(r, g))


def test_eos_alpha_beta(col, ref):
    """alpha, beta and alpha/beta at the interior W interfaces from T and
    S averaged there (LMD_DDMIX's profile)."""
    cfg, _, tcfg, _, a = col
    t_i = 0.5 * (a["t"][:, 1:] + a["t"][:, :-1])
    zw_i = a["z_w"][1:-1]
    got = teos_alpha_beta(tcfg, _t(t_i), _t(zw_i))
    assert len(got) == 3 and got[2].shape == zw_i.shape
    _assert_close(ref["aob"], got)


def test_lmd_vmix_interior(col, ref):
    cfg, _, tcfg, _, a = col
    got = tlmd.lmd_vmix_interior(tcfg, *_t([a[k] for k in (
        "u", "v", "bvf", "Hz")]))
    _assert_close(ref["interior"], got)
    # the shear, wave and convective regimes all reached
    bvf = a["bvf"][1:-1]
    assert (bvf < tlmd.LMD_BVFCON).any() and (bvf > 1e-7).any()


def test_lmd_ddmix(col, ref):
    """Salt fingering and diffusive convection: the increments of both
    tracers' Akt, with each regime reached at some interface."""
    cfg, _, tcfg, _, a = col
    aob = ref["aob"][2]
    got = tlmd.lmd_ddmix(tcfg, _t(a["t"]), _t(aob), _t(ref["Akt0"]))
    _assert_close([ref["ddmix"]], [got])
    dT = np.diff(a["t"][0], axis=0)
    dS = np.diff(a["t"][1], axis=0)
    Rrho = aob * dT / dS
    assert ((Rrho > 1.0) & (Rrho < tlmd.LMD_RRHO0) & (dS > 0)).any()
    assert ((Rrho > 0.0) & (Rrho < 1.0) & (dS < 0)).any()


@pytest.mark.parametrize("routine", ["skpp", "bkpp"])
def test_lmd_boundary_layers(col, ref, routine):
    """The surface layer (Akv, Akt, ghats, hsbl) and the bottom one
    (Akv, Akt, hbbl, guarded by the surface layer's level), each from
    roms_tpu's coefficients before it, with their regimes reached."""
    cfg, grid, tcfg, tgrid, a = col
    _, tf = _forcings(a)
    targs = _t([a[k] for k in NAMES])
    z_w, hsbl = a["z_w"], ref["skpp"][3]
    if routine == "skpp":
        got = tlmd.lmd_skpp(tcfg, tgrid, *targs, tf,
                            *_t(list(ref["interior"])))
        _assert_close(ref["skpp"], got)
        # columns with and without a crossing; the stable cap
        assert 0 < (hsbl == z_w[1]).sum() < hsbl.size
        assert (hsbl > z_w[1]).any()
        assert np.array_equal(t2n(tlmd.surface_ksbl(_t(z_w), got[3])),
                              ref["ksbl"])
        return
    got = tlmd.lmd_bkpp(tcfg, tgrid, *targs, tf, _t(a["bustr"]),
                        _t(a["bvstr"]), *_t(list(ref["skpp"][:2])),
                        ksbl_guard=_t(ref["ksbl"]))
    _assert_close(ref["bkpp"], got)
    hbbl = ref["bkpp"][2]
    assert (hbbl < z_w[-1]).any() and (hbbl > z_w[0]).all()
    # the guard acts: some bottom-layer interfaces lie in the surface one
    kif = np.arange(1, cfg.N)[:, None, None]
    assert ((z_w[1:-1] < hbbl[None]) & (ref["ksbl"][None] < kif)).any()


def test_log_drag_at_both_clip_ends():
    """UV_LOGDRAG on an NS-periodic grid whose depths put cd at Cdb_max
    (shallow cells, where z_r - z_w < Zob makes the log negative), at
    Cdb_min and between them."""
    cfg = ia.mixed_layer_config(Lm=8, Mm=7, N=4)
    cfg = cfg.replace(drag=dataclasses.replace(cfg.drag, Cdb_min=4.0e-3))
    rng = np.random.default_rng(4)
    # h = 0.12 m * 4**i across the lanes: z_r[0] - z_w[0] from 0.015 m
    # (below Zob = 0.02 m) to kilometres
    dx = 500.0 / cfg.Lm
    grid = ia._plane_grid(cfg, 500.0, 400.0, 50.0, f0=0.0,
                          h2d=lambda x, y: 0.12 * 4.0 ** (x / dx + 0.5)
                          + 0.0 * y)
    shp3 = (cfg.N,) + cfg.shape2d
    u = _periodic(0.2 * rng.standard_normal(shp3))
    v = _periodic(0.2 * rng.standard_normal(shp3))
    z_r, z_w, Hz = set_depth(grid, jnp.zeros(cfg.shape2d))
    ref = set_vbc.bottom_drag(cfg, grid, u, v, Hz, z_r, z_w)
    tcfg, tgrid = port(cfg, grid)
    tz = _t([z_r, z_w, Hz])
    got = tset_vbc.bottom_drag(tcfg, tgrid, _t(u), _t(v), tz[2], tz[0],
                               tz[1])
    _assert_close(ref, got)
    cd = t2n(tset_vbc.log_drag_coef(tcfg, tz[0], tz[1]))
    d = cfg.drag
    assert (cd == d.Cdb_max).any() and (cd == d.Cdb_min).any()
    assert ((cd > d.Cdb_min) & (cd < d.Cdb_max)).any()


@pytest.fixture(scope="module")
def bl_runs():
    """3 BENCHMARK full-physics steps with LMD_BKPP and LMD_DDMIX (BL_TEST's
    closure set) from a seeded, zonally varying state through either
    package, and the shapes of the port's spline solves that went through
    kernel 17's wrapper (its plain sweep on CPU tensors)."""
    torch.set_num_threads(1)
    cfg = bm.make_config(Lm=10, Mm=8, N=6, dtype="float64",
                         full_physics=True)
    cfg = cfg.replace(mixing=dataclasses.replace(cfg.mixing, bkpp=True,
                                                 ddmix=True))
    grid = bm.make_grid(cfg)
    s0 = bm.make_initial(cfg, grid)
    rng = np.random.default_rng(8)

    def r(shape, scale):
        return st.periodic_x(jnp.asarray(scale * rng.standard_normal(shape)))

    s0 = s0._replace(u=s0.u + r(s0.u.shape, 0.02) * grid.umask,
                     v=s0.v + r(s0.v.shape, 0.02) * grid.vmask,
                     t=s0.t + r(s0.t.shape, 0.1))
    ref = reference_run(stepping.Model(cfg, grid, bm.make_bulk_forcing_fn(
        cfg, grid)), s0, 3)
    tcfg, tgrid, ts0 = port(cfg, grid, s0)
    model = tstepping.Model(tcfg, tgrid, tbm.make_bulk_forcing_fn(
        tcfg, tgrid))
    solve, solves = ttridiag.tridiag_solve, []

    def spy(*args):
        solves.append(tuple(args[3].shape))
        return solve(*args)
    ttridiag.tridiag_solve = spy
    try:
        got = model.run(ts0, 3)
    finally:
        ttridiag.tridiag_solve = solve
    return cfg, model, ref, got, solves


def test_benchmark_bkpp_ddmix_solves_through_the_wrapper(bl_runs):
    """The whole-array route's eight spline solves a step reach kernel
    17's wrapper."""
    cfg, model, _, _, solves = bl_runs
    assert model.kpp_route == "whole_array"
    assert solves == [(cfg.N - 1,) + cfg.shape2d] * 24


@pytest.mark.parametrize("field", FIELDS)
def test_benchmark_bkpp_ddmix_trajectory(bl_runs, field):
    """The port's whole-array route against roms_tpu's jnp route."""
    *_, ref, got, _ = bl_runs
    x, y = np.asarray(getattr(ref, field)), t2n(getattr(got, field))
    assert np.isfinite(y).all(), field
    scale = np.abs(x).max()
    assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
        (field, np.abs(y - x).max(), scale)
