"""The ten analytical applications that need only ported physics (BASIN,
SEAMOUNT, GRAV_ADJ, CANYON, WINDBASIN, CHANNEL, and LAKE_SIGNELL,
LMD_TEST, MIXED_LAYER and LAB_CANYON with the NS-periodic grids, the
logarithmic drag and the whole-array LMD route) against roms_tpu on the
CPU, float64, at Lm = 10, Mm = 8, N = 4 (SEAMOUNT keeps its seamount,
~1.3 cells wide; LAKE_SIGNELL keeps its published Mm = 20, on which its
southern shore stays 1.2 m deep, LMD_TEST runs at N = 8, and MIXED_LAYER
at its published 5 x 4 x 30, since at Lm = 10 its 3 s barotropic step
breaks the CFL limit in either package):

- the port's grid, initial state and forcing equal roms_tpu's;
- a 3-step trajectory of every prognostic field within the bound of
  tests/test_correctness_gates.py:65, 1e-10*max|x| + 5e-14, from the
  app's initial state with seeded (numpy) perturbations of u, v and the
  tracers, periodic lanes and rows copied on the periodic grids.  From
  the bare initial state BASIN's flow after 3 steps is ~1e-6 m/s, and
  the roundoff of its 5000 m baroclinic pressure gradient (~2e-13 m in
  zeta, in either package) is above the bound's share of that.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from roms_tpu.core import stepping
from roms_tpu.core.state import initial_state
from roms_tpu.functionals import idealized as ia
from roms_tpu.ops import stencil as st
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.functionals import idealized as tia

from torch_port_util import port, reference_run, rel_err, t2n

APPS = {"basin": "basin_forcing_fn", "seamount": None, "grav_adj": None,
        "canyon": None, "windbasin": "windbasin_forcing_fn",
        "channel": "channel_forcing_fn",
        "lake_signell": "lake_signell_forcing_fn",
        "lmd_test": "lmd_test_forcing_fn",
        "mixed_layer": "mixed_layer_forcing_fn", "lab_canyon": None}
SIZE = dict(Lm=10, Mm=8, N=4, dtype="float64")
RESIZED = {"lake_signell": dict(Mm=20), "lmd_test": dict(N=8),
           "mixed_layer": dict(Lm=5, Mm=4, N=30)}
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")


def _forcing(pkg, app, cfg, grid):
    name = APPS[app]
    if name is not None:
        return getattr(pkg, name)(cfg, grid)
    return ia.zero_forcing(cfg) if pkg is ia else \
        tia.zero_forcing(cfg, grid)


@pytest.fixture(scope="module", params=list(APPS))
def app(request):
    """One app at its test size: roms_tpu's (cfg, grid, initial state,
    forcing) and the port's own, each from its package's functionals."""
    name = request.param
    size = dict(SIZE, **RESIZED.get(name, {}))
    cfg = getattr(ia, f"{name}_config")(**size)
    grid = getattr(ia, f"{name}_grid")(cfg)
    tcfg = getattr(tia, f"{name}_config")(**size)
    tg = getattr(tia, f"{name}_grid")(tcfg, device="cpu")
    return SimpleNamespace(
        name=name, cfg=cfg, grid=grid,
        s=getattr(ia, f"{name}_initial")(cfg, grid),
        forcing=_forcing(ia, name, cfg, grid), tcfg=tcfg, tg=tg,
        ts=getattr(tia, f"{name}_initial")(tcfg, tg),
        tforcing=_forcing(tia, name, tcfg, tg))


def test_app_config(app):
    assert app.tcfg == port(app.cfg, app.grid)[0]


def test_app_grid(app):
    for name in ("h", "pm", "pn", "f", "xr", "yr", "on_u", "om_v",
                 "rmask", "angler", "dndx", "dmde", "Cs_r", "sc_w"):
        assert rel_err(getattr(app.grid, name),
                       getattr(app.tg, name)) < 1e-14, name


def test_app_initial_state(app):
    for name in FIELDS + ("z_r", "z_w", "Hz"):
        x, y = np.asarray(getattr(app.s, name)), t2n(getattr(app.ts, name))
        assert np.abs(x - y).max() <= 1e-14 * np.abs(x).max(), name


def test_app_forcing(app):
    for time in (0.0, 7200.0, 3.0 * 86400.0, 10.0 * 86400.0):
        a, b = app.forcing(time), app.tforcing(time)
        for name in a._fields:
            x, y = np.asarray(getattr(a, name)), t2n(getattr(b, name))
            assert np.abs(x - y).max() <= 1e-14 * np.abs(x).max(), name


@pytest.fixture(scope="module")
def runs(app):
    """3 steps of either package from the app's seeded initial state."""
    cfg, grid = app.cfg, app.grid
    rng = np.random.default_rng(15)

    def r(*shape, scale):
        x = jnp.asarray(scale * rng.standard_normal(shape))
        x = st.periodic_x(x) if cfg.bc.ew_periodic else x
        return st.periodic_y(x) if cfg.bc.ns_periodic else x

    s = app.s
    shp3 = (cfg.N,) + cfg.shape2d
    s = initial_state(cfg, grid, zeta=s.zeta,
                      u=s.u + r(*shp3, scale=0.05) * grid.umask,
                      v=s.v + r(*shp3, scale=0.05) * grid.vmask,
                      t=s.t + r(*s.t.shape, scale=0.1))
    ref = reference_run(stepping.Model(cfg, grid, forcing_fn=app.forcing),
                        s, 3)
    tcfg, tg, ts = port(cfg, grid, s)
    got = tstepping.Model(tcfg, tg, _forcing(tia, app.name, tcfg, tg)).run(
        ts, 3)
    return ref, got


@pytest.mark.parametrize("field", FIELDS)
def test_app_matches_roms_tpu(runs, field):
    ref, got = runs
    assert got.iic == 3
    x, y = np.asarray(getattr(ref, field)), t2n(getattr(got, field))
    assert np.isfinite(y).all(), field
    scale = np.abs(x).max()
    assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
        (field, np.abs(y - x).max(), scale)
