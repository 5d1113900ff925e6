"""Shared helpers of the NetCDF streams (from roms_tpu/io/_ncutil.py):
native-endian conversion for scipy's big-endian classic-NetCDF views,
the tracer-name table of the writers, and ghost-padding of standard
staggered layouts (xi_u = Lm+1 / eta_v = Mm+1) up to the uniform
(Mm+2, Lm+2) shape (grid/grid.py layout note).  roms_tpu's time-axis
helper belongs to its forcing readers, which are still to port.
"""

from __future__ import annotations

import numpy as np


def native(a):
    """A numpy array in native byte order (scipy's netcdf_file gives
    big-endian views)."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="))


def tracer_names(cfg):
    names = ["temp", "salt"]
    extra = list(getattr(cfg, "tracer_names", None) or ())
    for i in range(2, cfg.NT):
        j = i - 2
        names.append(extra[j] if j < len(extra)
                     else f"tracer{i + 1:02d}")
    return names[: cfg.NT]


def pad_to(a, shape2d):
    """Pad standard staggered arrays into the uniform full shape by
    replicating the first valid line into the ghost column/row."""
    Mj, Li = shape2d
    if a.shape[-1] == Li - 1:
        a = np.concatenate([a[..., :1], a], axis=-1)
    if a.shape[-2] == Mj - 1:
        a = np.concatenate([a[..., :1, :], a], axis=-2)
    return a
