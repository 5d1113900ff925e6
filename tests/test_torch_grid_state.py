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
