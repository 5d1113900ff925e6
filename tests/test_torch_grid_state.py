"""roms_tpu_torch's DOUBLE_GYRE configuration, grid and initial state
against roms_tpu's, float64 on the CPU (rel <= 1e-15), and the
convert.py hand-over of roms_tpu objects as plain data."""

import dataclasses

import numpy as np
import pytest
import torch

from roms_tpu.functionals import idealized as ia
from roms_tpu.grid.grid import Grid as JGrid
from roms_tpu_torch.functionals import idealized as tia
from roms_tpu_torch.grid.grid import Grid as TGrid

from torch_port_util import port, rel_err, t2n

GRID_FIELDS = [f for f in JGrid.FIELDS if f != "zice"]
STATE_FIELDS = ["zeta", "ubar", "vbar", "u", "v", "t", "t_prev",
                "ru_prev", "rv_prev", "ru_prev2", "rv_prev2", "ru0_prev",
                "rv0_prev", "ru0_prev2", "rv0_prev2", "z_r", "z_w", "Hz"]
SIZE = dict(Lm=16, Mm=32, N=6, dtype="float64")


@pytest.fixture(scope="module")
def both():
    torch.set_num_threads(1)
    cfg = ia.double_gyre_config(**SIZE)
    grid = ia.double_gyre_grid(cfg)
    state = ia.double_gyre_initial(cfg, grid)
    tcfg = tia.double_gyre_config(**SIZE)
    tgrid = tia.double_gyre_grid(tcfg, device="cpu")
    tstate = tia.double_gyre_initial(tcfg, tgrid)
    return cfg, grid, state, tcfg, tgrid, tstate


def test_config_equal_and_converted(both):
    cfg, _, _, tcfg, _, _ = both
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert TGrid.FIELDS == JGrid.FIELDS and TGrid.AUX == JGrid.AUX


@pytest.mark.parametrize("name", GRID_FIELDS)
def test_grid_field(both, name):
    _, grid, _, _, tgrid, _ = both
    ref = np.asarray(getattr(grid, name))
    got = getattr(tgrid, name)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    assert rel_err(ref, got) <= 1e-15 or np.abs(ref).max() == 0.0 and \
        not got.any()


def test_grid_aux(both):
    _, grid, _, _, tgrid, _ = both
    for name in JGrid.AUX:
        assert getattr(tgrid, name) == getattr(grid, name), name
    assert tgrid.zice is None and grid.zice is None


@pytest.mark.parametrize("name", STATE_FIELDS)
def test_initial_state_field(both, name):
    _, _, state, _, _, tstate = both
    ref = np.asarray(getattr(state, name))
    got = getattr(tstate, name)
    assert tuple(got.shape) == ref.shape
    if np.abs(ref).max() == 0.0:
        assert not got.any()
    else:
        assert rel_err(ref, got) <= 1e-15
    assert tstate.iic == int(state.iic) == 0
    assert tstate.time == float(state.time)


def test_convert_hands_over_exact_copies(both):
    cfg, grid, state, _, _, _ = both
    tcfg, tgrid, tstate = port(cfg, grid, state)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    for name in GRID_FIELDS:
        assert np.array_equal(t2n(getattr(tgrid, name)),
                              np.asarray(getattr(grid, name))), name
    for name in STATE_FIELDS:
        assert np.array_equal(t2n(getattr(tstate, name)),
                              np.asarray(getattr(state, name))), name
    assert tgrid.hc == grid.hc and tstate.iic == 0


def test_convert_carries_the_gls_mix_state():
    """A roms_tpu GLS MixState crosses to the port and back unchanged;
    the sediment, BBL and ice slots still raise."""
    import jax.numpy as jnp

    from roms_tpu.core import gls as jgls
    from roms_tpu.functionals import upwelling
    from roms_tpu_torch import convert
    from roms_tpu_torch.core.gls import MixState

    cfg = upwelling.make_config(Lm=6, Mm=8, N=4, dtype="float64")
    cfg = cfg.replace(mixing=dataclasses.replace(
        cfg.mixing, vmix="gls", gls_stab="kantha_clayson"))
    grid = upwelling.make_grid(cfg)
    state = upwelling.make_initial(cfg, grid)
    rng = np.random.default_rng(8)
    mix = jgls.MixState(*[jnp.asarray(rng.uniform(1e-8, 1e-2, x.shape))
                          for x in state.mix])
    state = state._replace(mix=mix)
    tcfg, _, tstate = port(cfg, grid, state)
    assert tuple(MixState._fields) == tuple(jgls.MixState._fields)
    for name in MixState._fields:
        got = getattr(tstate.mix, name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert np.array_equal(t2n(got), np.asarray(getattr(mix, name)))
    back = jgls.MixState(*[jnp.asarray(t2n(x)) for x in tstate.mix])
    for r, b in zip(mix, back):
        assert np.array_equal(np.asarray(r), np.asarray(b))
    again = convert.mix_from_dict(
        {k: np.asarray(v) for k, v in mix._asdict().items()}, tcfg,
        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, tstate.mix))
    for slot in ("sed", "bbl", "ice"):
        d = {n: np.asarray(getattr(state, n)) for n in STATE_FIELDS
             + ["time", "iic"]}
        d[slot] = np.zeros(1)
        with pytest.raises(NotImplementedError, match=slot):
            convert.state_from_dict(d, tcfg, device="cpu")
