"""Helpers shared by the tests/test_torch_*.py parity tests: hand
roms_tpu objects to roms_tpu_torch as plain data (roms_tpu_torch/
convert.py) and compare results as numpy arrays."""

import dataclasses

import numpy as np
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
