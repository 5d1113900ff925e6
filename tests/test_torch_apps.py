"""The six analytical applications that need only ported physics (BASIN,
SEAMOUNT, GRAV_ADJ, CANYON, WINDBASIN, CHANNEL) against roms_tpu on the
CPU, float64, at Lm = 10, Mm = 8, N = 4 (SEAMOUNT keeps its seamount,
~1.3 cells wide):

- the port's grid, initial state and forcing equal roms_tpu's;
- a 3-step trajectory of every prognostic field within the bound of
  tests/test_correctness_gates.py:65, 1e-10*max|x| + 5e-14, from the
  app's initial state with seeded (numpy) perturbations of u, v and the
  tracers, periodic lanes copied on the channels.  From the bare initial
  state BASIN's flow after 3 steps is ~1e-6 m/s, and the roundoff of its
  5000 m baroclinic pressure gradient (~2e-13 m in zeta, in either
  package) is above the bound's share of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from roms_tpu.core import stepping
from roms_tpu.core.state import initial_state
from roms_tpu.functionals import idealized as ia
from roms_tpu.ops import stencil as st
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.functionals import idealized as tia

from torch_port_util import port, rel_err, t2n

APPS = {"basin": "basin_forcing_fn", "seamount": None, "grav_adj": None,
        "canyon": None, "windbasin": "windbasin_forcing_fn",
        "channel": "channel_forcing_fn"}
SIZE = dict(Lm=10, Mm=8, N=4, dtype="float64")
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")
# roms_tpu's step compiled with XLA's backend optimisation off: the
# compile is most of this file's time, the step's arithmetic is the same
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}


def _forcing(pkg, app, cfg, grid):
    name = APPS[app]
    if name is not None:
        return getattr(pkg, name)(cfg, grid)
    return ia.zero_forcing(cfg) if pkg is ia else \
        tia.zero_forcing(cfg, grid)


@pytest.mark.parametrize("app", list(APPS))
def test_app_matches_roms_tpu(app):
    cfg = getattr(ia, f"{app}_config")(**SIZE)
    grid = getattr(ia, f"{app}_grid")(cfg)
    s = getattr(ia, f"{app}_initial")(cfg, grid)
    forcing = _forcing(ia, app, cfg, grid)

    # the port's own functionals
    tcfg = getattr(tia, f"{app}_config")(**SIZE)
    assert tcfg == port(cfg, grid)[0]
    tg = getattr(tia, f"{app}_grid")(tcfg, device="cpu")
    for name in ("h", "pm", "pn", "f", "xr", "yr", "on_u", "om_v",
                 "rmask", "Cs_r", "sc_w"):
        assert rel_err(getattr(grid, name), getattr(tg, name)) < 1e-14, name
    ts = getattr(tia, f"{app}_initial")(tcfg, tg)
    for name in FIELDS + ("z_r", "z_w", "Hz"):
        x, y = np.asarray(getattr(s, name)), t2n(getattr(ts, name))
        assert np.abs(x - y).max() <= 1e-14 * np.abs(x).max(), name
    tforcing = _forcing(tia, app, tcfg, tg)
    for time in (0.0, 7200.0, 3.0 * 86400.0, 10.0 * 86400.0):
        a, b = forcing(time), tforcing(time)
        for name in a._fields:
            x, y = np.asarray(getattr(a, name)), t2n(getattr(b, name))
            assert np.abs(x - y).max() <= 1e-14 * np.abs(x).max(), name

    # 3 steps from the seeded state
    rng = np.random.default_rng(15)

    def r(*shape, scale):
        x = jnp.asarray(scale * rng.standard_normal(shape))
        return st.periodic_x(x) if cfg.bc.ew_periodic else x

    shp3 = (cfg.N,) + cfg.shape2d
    s = initial_state(cfg, grid, zeta=s.zeta,
                      u=s.u + r(*shp3, scale=0.05) * grid.umask,
                      v=s.v + r(*shp3, scale=0.05) * grid.vmask,
                      t=s.t + r(*s.t.shape, scale=0.1))
    model = stepping.Model(cfg, grid, forcing_fn=forcing)
    step = jax.jit(model.step_impl).lower(s, grid).compile(XLA_FAST_COMPILE)
    ref = s
    for _ in range(3):
        ref = step(ref, grid)
    tcfg, tg, ts = port(cfg, grid, s)
    got = tstepping.Model(tcfg, tg, _forcing(tia, app, tcfg, tg)).run(ts, 3)
    assert got.iic == 3
    for name in FIELDS:
        x, y = np.asarray(getattr(ref, name)), t2n(getattr(got, name))
        assert np.isfinite(y).all(), name
        scale = np.abs(x).max()
        assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
            (name, np.abs(y - x).max(), scale)
