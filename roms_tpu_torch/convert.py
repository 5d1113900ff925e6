"""Build the port's objects from roms_tpu's, handed over as plain data.

The port never imports roms_tpu, so a caller that holds roms_tpu
objects passes them as plain Python data:

  cfg   -> dataclasses.asdict(cfg)                        (nested dict)
  grid  -> {name: np.asarray(getattr(grid, name))
            for name in Grid.FIELDS + Grid.AUX}          (None stays None)
  state -> {name: np.asarray(value)} for State's fields  (None stays None;
            a GLS/MY2.5 `mix` as {name: np.asarray(value)} for
            MixState's fields, e.g. mix._asdict())

and gets back a ModelConfig, Grid or State of roms_tpu_torch on the
requested device, holding the same numbers.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .config import ModelConfig
from .core.gls import MixState
from .core.state import State
from .device import resolve_device, torch_dtype
from .grid.grid import Grid


def _dataclass_from_dict(cls, d):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        val = d[f.name]
        typ = hints.get(f.name)
        if isinstance(val, dict) and dataclasses.is_dataclass(typ):
            val = _dataclass_from_dict(typ, val)
        elif isinstance(val, list):
            val = tuple(val)
        kw[f.name] = val
    return cls(**kw)


def config_from_dict(d: dict) -> ModelConfig:
    """ModelConfig from dataclasses.asdict(roms_tpu ModelConfig)."""
    return _dataclass_from_dict(ModelConfig, d)


def _tensor(x, device, dtype):
    return torch.as_tensor(np.array(x)).to(device=device, dtype=dtype)


def grid_from_dict(d: dict, cfg: ModelConfig, device="cuda") -> Grid:
    """Grid from roms_tpu Grid fields and aux scalars."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    if d.get("zice") is not None:
        raise NotImplementedError("ICESHELF grids: ROADMAP Queue 1 item 8")
    kw = {name: (None if d.get(name) is None
                 else _tensor(d[name], dev, dtype))
          for name in Grid.FIELDS}
    for name in Grid.AUX:
        val = d[name]
        kw[name] = val.item() if isinstance(val, np.ndarray) else val
    kw["hc"] = float(kw["hc"])
    return Grid(**kw)


def mix_from_dict(d: dict, cfg: ModelConfig, device="cuda") -> MixState:
    """GLS/MY2.5 MixState from roms_tpu MixState fields."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    return MixState(**{name: _tensor(d[name], dev, dtype)
                       for name in MixState._fields})


def state_from_dict(d: dict, cfg: ModelConfig, device="cuda") -> State:
    """State from roms_tpu State fields (time and iic become Python
    numbers; `mix` crosses by mix_from_dict; roms_tpu's sediment, BBL
    and ice slots must be None)."""
    for name in ("sed", "bbl", "ice"):
        if d.get(name) is not None:
            raise NotImplementedError(f"State.{name}: not ported yet")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    kw = {}
    for name in State._fields:
        if name == "time":
            kw[name] = float(np.asarray(d[name]))
        elif name == "iic":
            kw[name] = int(np.asarray(d[name]))
        elif name == "mix":
            kw[name] = None if d.get(name) is None \
                else mix_from_dict(d[name], cfg, dev)
        else:
            kw[name] = _tensor(d[name], dev, dtype)
    return State(**kw)
