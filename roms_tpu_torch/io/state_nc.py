"""Initial state from HIS/INI-layout NetCDF (port of
roms_tpu/io/state_nc.py; get_state.F analog).

The reference cold/warm-starts an application from an ININAME NetCDF
file through the generic get_state reader (ROMS/Utility/get_state.F:
89-157): it locates the requested record (NRREC, or the latest), reads
each prognostic field found in the file and leaves everything else at
its initialized value.  zeta/ubar/vbar/u/v/temp/salt (+ extra tracers)
are read when present; the depths, vertical means and mixing state are
rebuilt by core.state.initial_state, as the reference's initial.F does
after the read (set_depth -> set_massflux -> omega -> rho_eos,
initial.F:341,562-577).

For a bit-exact restart of an interrupted run use io/rst_netcdf.py (the
PERFECT_RESTART stream); this reader is the plain INI path for files
produced by the reference, by tooling, or by the history writer.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from ..config import ModelConfig
from ..core.state import State, initial_state
from ._ncutil import native, pad_to, tracer_names


def read_state_netcdf(path: str, cfg: ModelConfig, grid,
                      rec: int = -1) -> State:
    """The initial State from an INI/HIS-layout NetCDF record on the
    grid's device.

    rec: record index (negative = from the end, the reference's NRREC<=0
    "latest record").  Fields absent from the file start at rest, as in
    ana_initial cold starts.
    """
    with netcdf_file(path, "r", mmap=False) as f:
        nrec = f.variables["ocean_time"].shape[0]
        if rec < 0:
            rec = nrec + rec
        time0 = float(native(f.variables["ocean_time"][rec]))

        def get(name):
            if name not in f.variables:
                return None
            return pad_to(native(f.variables[name][rec]), cfg.shape2d)

        zeta = get("zeta")
        u = get("u")
        v = get("v")
        ubar = get("ubar")
        vbar = get("vbar")
        tr = [get(nm) for nm in tracer_names(cfg)]
    N, Mj, Li = cfg.N, *cfg.shape2d
    t = np.stack([x if x is not None else np.zeros((N, Mj, Li))
                  for x in tr])

    s = initial_state(cfg, grid, zeta=zeta, u=u, v=v, t=t, time0=time0)
    # the file's own vertical means take precedence over the recomputed
    # ones when stored (ini_fields.F derives them only if absent)
    repl = {}
    if ubar is not None:
        repl["ubar"] = s.ubar.new_tensor(ubar)
    if vbar is not None:
        repl["vbar"] = s.vbar.new_tensor(vbar)
    return s._replace(**repl) if repl else s
