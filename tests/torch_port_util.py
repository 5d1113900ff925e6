"""Helpers shared by the tests/test_torch_*.py parity tests: hand
roms_tpu objects to roms_tpu_torch as plain data (roms_tpu_torch/
convert.py), step roms_tpu's reference model, and compare results as
numpy arrays."""

import dataclasses

import numpy as np
import pytest
import torch

from roms_tpu_torch import convert


def cfg_dict(cfg):
    return dataclasses.asdict(cfg)


def grid_dict(grid):
    names = type(grid).FIELDS + type(grid).AUX
    return {n: (None if getattr(grid, n) is None
                else np.asarray(getattr(grid, n))) for n in names}


def state_dict(state):
    """State fields as numpy arrays; a GLS/MY2.5 `mix` as a dict of
    its fields."""
    def plain(x):
        if x is None:
            return None
        if hasattr(x, "_asdict"):
            return {k: np.asarray(v) for k, v in x._asdict().items()}
        return np.asarray(x)
    return {n: plain(getattr(state, n)) for n in state._fields}


def port(cfg, grid, state=None):
    """(cfg, grid[, state]) of roms_tpu as roms_tpu_torch objects on
    the CPU."""
    tcfg = convert.config_from_dict(cfg_dict(cfg))
    tgrid = convert.grid_from_dict(grid_dict(grid), tcfg, device="cpu")
    if state is None:
        return tcfg, tgrid
    return tcfg, tgrid, convert.state_from_dict(state_dict(state), tcfg,
                                                device="cpu")


def t2n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rel_err(ref, got, sl=(Ellipsis,)):
    """max|got - ref| / max|ref| over the slice `sl`."""
    r = np.asarray(ref)[sl]
    g = t2n(got)[sl]
    assert r.shape == g.shape, (r.shape, g.shape)
    return float(np.abs(g - r).max() / (np.abs(r).max() + 1e-300))


# roms_tpu's step compiled with XLA's backend optimisation off: the
# compile is most of a reference trajectory's time, the step's
# arithmetic is the same
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def xla_fast_compiles():
    """A test module that imports this fixture compiles every roms_tpu
    program with XLA's backend optimisation off, as XLA_FAST_COMPILE:
    the roms_tpu functionals' eager ops, its drivers' steps and its
    interpreted Pallas kernels.  Not for checks at the last bits of a
    transcendental: unoptimised XLA evaluates tanh an ulp apart, which
    LAKE_SIGNELL's wind ramp at t = 0 (1 + tanh(-7.5)) turns into
    1.8e-10 relative, so tests/test_torch_apps.py does without it."""
    import jax
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def reference_run(model, state, nsteps, grid=None):
    """nsteps of roms_tpu's Model `model` from `state`: its step_impl
    compiled once (XLA_FAST_COMPILE) and called nsteps times, the
    dataflow of Model.run's scan."""
    import jax
    grid = model.grid if grid is None else grid
    step = jax.jit(model.step_impl).lower(state, grid).compile(
        XLA_FAST_COMPILE)
    for _ in range(nsteps):
        state = step(state, grid)
    return state
