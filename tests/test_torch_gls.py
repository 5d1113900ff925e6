"""Slice 4 of roms_tpu_torch, the UPWELLING channel with the GLS and
MY2.5 closures, against roms_tpu on the CPU: float64, inputs from a
numpy seed on a small UPWELLING grid, zonally varying, with periodic
lanes that hold their copies, as in a model state.

- kernel 17's plain version `tridiag_plain` against the Pallas kernel in
  interpret mode (as tests/test_pallas_tridiag.py runs it) and roms_tpu's
  scan, relative 1e-12, on shapes that are and are not tile multiples;
  the wrapper's refusal outside `covers` and the closures' call-site
  gate (`closure_solve`);
- the closure's pieces (shear2_spline, n2s2_horavg, gls_prestep at iic 0
  and 2, gls_corstep with Canuto-A, Kantha-Clayson and the k-kl preset,
  my25_corstep) and make_bvf_mix against roms_tpu, relative 1e-12;
- 3-step GLS (Kantha-Clayson) and MY2.5 UPWELLING trajectories within
  the cross-engine bound 1e-10*max|x| + 5e-14, each step handing its
  four solves to kernel 17's wrapper.

The CUDA kernel itself needs a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.core import gls as jgls, my25 as jmy25, stepping
from roms_tpu.core.omega import omega
from roms_tpu.core.rho_eos import rho_eos
from roms_tpu.functionals import upwelling as up
from roms_tpu.grid.depth import set_depth, set_massflux
from roms_tpu.ops import stencil as st
from roms_tpu.ops.pallas_tridiag import tridiag_solve_pallas
from roms_tpu.ops.tridiag import tridiag_solve as jtridiag
from roms_tpu_torch import convert
from roms_tpu_torch.core import gls as tgls, my25 as tmy25
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.functionals import upwelling as tup
from roms_tpu_torch.ops import _lib, tridiag as ttridiag

from torch_port_util import port, reference_run, rel_err, t2n

TOL = 1e-12
MIX_FIELDS = ("tke", "gls", "Akv", "Akt", "Akk", "Akp", "Lscale")
TRAJ_FIELDS = ("zeta", "u", "v", "t", "tke", "gls", "Akv", "Akt")


def _t(x):
    if isinstance(x, (list, tuple)):
        return [_t(y) for y in x]
    return torch.from_numpy(np.array(x))


def _gls_cfg(cfg, kind):
    """UPWELLING with the closure `kind`, built as tests/test_gls.py and
    tests/test_my25.py build it."""
    if kind == "kkl":
        return cfg.replace(mixing=jgls.my25_mixing_config(cfg.mixing))
    if kind == "my25":
        return cfg.replace(mixing=dataclasses.replace(cfg.mixing,
                                                      vmix="my25"))
    return cfg.replace(mixing=dataclasses.replace(cfg.mixing, vmix="gls",
                                                  gls_stab=kind))


# --------------------------------------------------------------------------
# kernel 17's plain version
# --------------------------------------------------------------------------

def _systems(rng, N, Mj, Li):
    a = rng.uniform(0.1, 0.5, (N, Mj, Li)) * rng.choice([-1.0, 1.0],
                                                       (N, Mj, Li))
    b = rng.uniform(2.0, 3.0, (N, Mj, Li))
    c = rng.uniform(0.1, 0.5, (N, Mj, Li))
    d = rng.normal(size=(N, Mj, Li))
    return a, b, c, d


@pytest.mark.parametrize("shape,tile", [
    ((12, 10, 20), (8, 16)),        # Li a tile multiple, Mj not
    ((7, 13, 29), (8, 16)),         # neither
    ((15, 14, 12), (8, 512)),       # the GLS depth at N=16, roms_tpu tiles
])
def test_tridiag_plain(shape, tile):
    rng = np.random.default_rng(sum(shape))
    arrs = _systems(rng, *shape)
    got = ttridiag.tridiag_plain(*_t(arrs))
    ref_scan = jtridiag(*[jnp.asarray(x) for x in arrs])
    ref_pallas = tridiag_solve_pallas(*[jnp.asarray(x) for x in arrs],
                                      tj=tile[0], ti=tile[1],
                                      interpret=True)
    assert rel_err(ref_scan, got) <= TOL
    assert rel_err(ref_pallas, got) <= TOL


def test_tridiag_wrapper_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain sweep and launches nothing;
    `covers` is roms_tpu's gate: 3-D operands with N <= 128."""
    rng = np.random.default_rng(5)
    arrs = _t(_systems(rng, 6, 5, 7))
    before = dict(_lib.launches)
    for kern in (True, False):
        out = ttridiag.tridiag_solve(*arrs, use_kernels=kern)
        assert torch.equal(out, ttridiag.tridiag_plain(*arrs))
    assert _lib.launches == before
    assert ttridiag.covers(arrs[3])
    assert not ttridiag.covers(torch.stack([arrs[3], arrs[3]]))
    assert ttridiag.covers(torch.zeros(128, 2, 2))
    assert not ttridiag.covers(torch.zeros(129, 2, 2))


@pytest.mark.parametrize("shape", [(129, 2, 3), (4, 2, 2, 3)])
def test_tridiag_wrapper_refuses_what_it_does_not_cover(shape):
    """Off the CPU the wrapper launches the kernel or raises: an operand
    outside `covers` raises before the kernel library is touched (meta
    tensors stand in for the card's)."""
    x = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="tridiag"):
        ttridiag.tridiag_solve(x, x, x, x)


@pytest.mark.parametrize("levels,kernel", [(128, True), (129, False)])
def test_closure_solve_gates_on_the_kernel_class(monkeypatch, levels,
                                                 kernel):
    """The closures' call-site gate hands systems of at most 128 levels
    to kernel 17's wrapper and deeper ones to the plain sweep, as
    roms_tpu's dispatcher takes its scan."""
    arrs = _t(_systems(np.random.default_rng(9), levels, 2, 3))
    want = ttridiag.tridiag_plain(*arrs)
    calls = []
    for name in ("tridiag_solve", "tridiag_plain"):
        def spy(*args, _name=name, _fn=getattr(ttridiag, name)):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(ttridiag, name, spy)
    assert torch.equal(tgls.closure_solve(*arrs), want)
    assert calls[0] == ("tridiag_solve" if kernel else "tridiag_plain")


# --------------------------------------------------------------------------
# the closures' pieces on seeded inputs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gc():
    """UPWELLING at Lm=10, Mm=12, N=6 with seeded, zonally varying
    fields and turbulence state, as JAX arrays, plus the grid."""
    torch.set_num_threads(1)
    cfg = up.make_config(Lm=10, Mm=12, N=6, dtype="float64")
    grid = up.make_grid(cfg)
    s = up.make_initial(cfg, grid)
    rng = np.random.default_rng(44)
    N, (Mj, Li) = cfg.N, cfg.shape2d

    def rnd(*shape):
        return st.periodic_x(jnp.asarray(rng.standard_normal(shape)))

    def pos(scale, base, *shape):
        return st.periodic_x(jnp.asarray(
            base + scale * np.abs(rng.standard_normal(shape))))

    z_r, z_w, Hz = set_depth(grid, 0.05 * rnd(Mj, Li))
    u = 0.1 * rnd(N, Mj, Li) * grid.umask
    v = 0.1 * rnd(N, Mj, Li) * grid.vmask
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    W = omega(cfg, grid, Huon, Hvom, z_w)
    t = s.t + 1.0 * rnd(*s.t.shape)
    bvf = rho_eos(cfg, t, z_r, Hz, z_w)[4]
    shp = (N + 1, Mj, Li)
    tke = pos(1e-4, 1e-6, *shp)
    gls = pos(1e-6, 1e-9, *shp)
    mix = jgls.MixState(
        tke=tke, tke_prev=tke + pos(1e-5, 0.0, *shp), gls=gls,
        gls_prev=gls + pos(1e-7, 0.0, *shp),
        Akv=pos(1e-3, 1e-5, *shp), Akt=pos(1e-4, 1e-6, 2, *shp),
        Akk=pos(1e-3, 5e-6, *shp), Akp=pos(1e-3, 5e-6, *shp),
        Lscale=pos(1.0, 1e-6, *shp))
    stress = [1e-4 * rnd(Mj, Li) for _ in range(4)]
    a = dict(z_r=z_r, z_w=z_w, Hz=Hz, u=u, v=v, Huon=Huon, Hvom=Hvom, W=W,
             bvf=bvf, mix=mix, stress=stress)
    return cfg, grid, a


def _port_mix(mix):
    return tgls.MixState(*_t(list(mix)))


def _check_mix(ref, got):
    for name in MIX_FIELDS:
        assert rel_err(getattr(ref, name), getattr(got, name)) <= TOL, name


def test_shear2_spline_and_n2s2_horavg(gc):
    cfg, grid, a = gc
    tcfg, _ = port(cfg, grid)
    ref = jgls.shear2_spline(a["u"], a["v"], a["Hz"])
    got = tgls.shear2_spline(*_t([a["u"], a["v"], a["Hz"]]))
    assert got.shape == ref.shape == (cfg.N - 1,) + cfg.shape2d
    assert rel_err(ref, got) <= TOL
    for f in (ref, a["bvf"][1:-1]):
        assert rel_err(jgls.n2s2_horavg(cfg, f),
                       tgls.n2s2_horavg(tcfg, _t(f))) <= TOL


@pytest.mark.parametrize("iic", [0, 2])
def test_gls_prestep(gc, iic):
    cfg, grid, a = gc
    tcfg, tgrid = port(cfg, grid)
    args = [a[k] for k in ("Huon", "Hvom", "W", "Hz")]
    ref = jgls.gls_prestep(cfg, grid, a["mix"], *args, iic)
    got = tgls.gls_prestep(tcfg, tgrid, _port_mix(a["mix"]), *_t(args),
                           iic)
    assert len(ref) == len(got) == 4
    for r, g in zip(ref, got):
        assert rel_err(r, g) <= TOL


def _corstep_args(cfg, grid, a):
    half = jgls.gls_prestep(cfg, grid, a["mix"], a["Huon"], a["Hvom"],
                            a["W"], a["Hz"], 2)
    rest = [a[k] for k in ("u", "v", "Hz", "z_r", "z_w", "Huon", "Hvom",
                           "W", "bvf")] + a["stress"]
    return list(half) + rest


@pytest.mark.parametrize("kind", ["canuto_a", "kantha_clayson", "kkl",
                                  "my25"])
def test_corstep(gc, kind):
    cfg, grid, a = gc
    cfg = _gls_cfg(cfg, kind)
    tcfg, tgrid = port(cfg, grid)
    args = _corstep_args(cfg, grid, a)
    jfn, tfn = (jmy25.my25_corstep, tmy25.my25_corstep) if kind == "my25" \
        else (jgls.gls_corstep, tgls.gls_corstep)
    ref = jfn(cfg, grid, a["mix"], *args)
    got = tfn(tcfg, tgrid, _port_mix(a["mix"]), *_t(args))
    _check_mix(ref, got)
    assert torch.equal(got.tke_prev, _t(a["mix"].tke))


def test_initial_mix(gc):
    cfg, grid, _ = gc
    for kind in ("kantha_clayson", "my25"):
        c = _gls_cfg(cfg, kind)
        tcfg = convert.config_from_dict(dataclasses.asdict(c))
        ref = up.make_initial(c, grid).mix
        got = tgls.initial_mix(tcfg, "cpu") if kind != "my25" \
            else tmy25.initial_mix_my25(tcfg, "cpu")
        for name in tgls.MixState._fields:
            assert np.array_equal(np.asarray(getattr(ref, name)),
                                  t2n(getattr(got, name))), name


def test_make_bvf_mix(gc):
    cfg, grid, _ = gc
    tcfg, tgrid = port(cfg, grid)
    s = up.make_initial(cfg, grid)
    # a seeded stratification with unstable columns
    t = s.t + jnp.asarray(np.random.default_rng(9).standard_normal(
        s.t.shape))
    s = s._replace(t=st.periodic_x(t))
    _, _, ts = port(cfg, grid, s)
    ref = stepping.make_bvf_mix(cfg)(s, grid, s.z_w)
    got = tstepping.make_bvf_mix(tcfg)(ts, tgrid, ts.z_w)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and rel_err(r, g) <= TOL
    assert float(got[0].max()) == 1.0


# --------------------------------------------------------------------------
# the slice: GLS and MY2.5 UPWELLING trajectories
# --------------------------------------------------------------------------

def _trajectory(kind):
    torch.set_num_threads(1)
    cfg = _gls_cfg(up.make_config(Lm=10, Mm=12, N=6, dtype="float64"),
                   kind)
    grid = up.make_grid(cfg)
    s0 = up.make_initial(cfg, grid)
    rng = np.random.default_rng(3)
    s0 = s0._replace(
        u=s0.u + jnp.asarray(0.01 * rng.standard_normal(s0.u.shape))
        * grid.umask,
        t=s0.t + jnp.asarray(0.1 * rng.standard_normal(s0.t.shape)))
    ref = reference_run(stepping.Model(cfg, grid,
                                       up.make_forcing_fn(cfg, grid)), s0, 3)
    tcfg, tgrid, ts0 = port(cfg, grid, s0)
    before = dict(_lib.launches)
    solve, solves = ttridiag.tridiag_solve, []

    def spy(*args):
        solves.append(args[3].shape)
        return solve(*args)
    ttridiag.tridiag_solve = spy
    try:
        got = tstepping.Model(tcfg, tgrid,
                              tup.make_forcing_fn(tcfg, tgrid)).run(ts0, 3)
    finally:
        ttridiag.tridiag_solve = solve
    assert _lib.launches == before
    return ref, got, solves


@pytest.fixture(scope="module")
def gls_run():
    return _trajectory("kantha_clayson")


@pytest.fixture(scope="module")
def my25_run():
    return _trajectory("my25")


def _field(state, name):
    return getattr(state.mix, name) if name in MIX_FIELDS \
        else getattr(state, name)


@pytest.mark.parametrize("kind", ["gls", "my25"])
@pytest.mark.parametrize("field", TRAJ_FIELDS)
def test_trajectory_matches_roms_tpu(request, kind, field):
    ref, got, _ = request.getfixturevalue(f"{kind}_run")
    x = np.asarray(_field(ref, field))
    y = t2n(_field(got, field))
    assert x.shape == y.shape and np.isfinite(y).all()
    scale = np.abs(x).max() + 1e-30
    assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
        (field, np.abs(y - x).max(), scale)


@pytest.mark.parametrize("kind", ["gls", "my25"])
def test_closure_step_solves_through_the_wrapper(request, kind):
    """Each step hands its four systems of the N-1 interior interfaces
    to kernel 17's wrapper: two spline shear solves and the two
    turbulence solves."""
    *_, solves = request.getfixturevalue(f"{kind}_run")
    assert solves == [(5, 14, 12)] * 12
