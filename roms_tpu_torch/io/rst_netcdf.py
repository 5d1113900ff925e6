"""NetCDF restart stream in reference-compatible layout (port of
roms_tpu/io/rst_netcdf.py).

The reference writes restart records through def_rst.F/wrt_rst.F and
reads them back via get_state.F:89-157; with PERFECT_RESTART it also
stores the extra time levels and RHS histories (wrt_rst.F:43,142-178),
so a stop/restart run is bit-reproducible.  The prognostic fields carry
the reference's variable names and C-grid dimensions (zeta/ubar/vbar/
u/v/temp/salt on ocean_time x [s_rho] x eta_* x xi_*), the
perfect-restart history slots (AB histories, t_prev, 2D coupling
forcing, depths, GLS/MY2.5 turbulence state) ride along under
roms_tpu's names, so the two packages read each other's files.
`LcycleRST` (roms_upwelling.in:261) is kept by ``cycle=2``: records
alternate 0/1 and the file never grows.

Bit-exactness contract: step(read(write(s))) == step(s) bit for bit,
because every tensor the step consumes is stored at its own dtype and
read back at the stored dtype (scipy's big-endian views converted to
native order first).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.io import netcdf_file

from ..config import ModelConfig
from ..core.state import State
from ._ncutil import native
from .netcdf import host
from .varinfo import REGISTRY, dims_for

# State fields written under reference names (wrt_rst.F field list).
_CORE = (
    ("zeta", "zeta", "r2"),
    ("ubar", "ubar", "u2"),
    ("vbar", "vbar", "v2"),
    ("u", "u", "u3"),
    ("v", "v", "v3"),
)

# Perfect-restart companions (PERFECT_RESTART extra records,
# wrt_rst.F:142-178): AB histories, predictor level, 2D coupling
# forcing, and the depth arrays the correctors consumed.
_HIST2 = ("ru0_prev", "rv0_prev", "ru0_prev2", "rv0_prev2")
_HIST3 = ("ru_prev", "rv_prev", "ru_prev2", "rv_prev2", "z_r", "Hz")
_MIX_FIELDS = ("tke", "tke_prev", "gls", "gls_prev", "Akv", "Akt",
               "Akk", "Akp", "Lscale")


def _nc_code(dtype) -> str:
    return {"float32": "f", "float64": "d"}[str(dtype)]


def _tracer_names(cfg: ModelConfig):
    names = ["temp", "salt"]
    for i in range(2, cfg.NT):
        names.append(f"tracer{i + 1:02d}")
    return names[: cfg.NT]


class RestartWriter:
    """def_rst.F + wrt_rst.F analog: reference-layout NetCDF restart.

    cycle: number of records to cycle over (2 = LcycleRST; 0 = append
    forever).
    """

    def __init__(self, path: str, cfg: ModelConfig, grid, cycle: int = 2):
        self.cfg = cfg
        self.cycle = cycle
        self.nrec = 0
        Mj, Li = cfg.shape2d
        N = cfg.N
        f = netcdf_file(path, "w", version=2)
        f.type = "ROMS/TOMS restart file"
        f.history = "roms_tpu_torch restart file (perfect restart)"
        f.Vtransform = cfg.vert.Vtransform
        f.Vstretching = cfg.vert.Vstretching
        f.createDimension("ocean_time", None)
        for d, n in (("xi_rho", Li), ("xi_u", Li), ("xi_v", Li),
                     ("eta_rho", Mj), ("eta_u", Mj), ("eta_v", Mj),
                     ("s_rho", N), ("s_w", N + 1)):
            f.createDimension(d, n)

        vt = f.createVariable("ocean_time", "d", ("ocean_time",))
        vt.units = "seconds since initialization"
        self._time = vt
        vi = f.createVariable("nsteps", "i", ("ocean_time",))
        vi.long_name = "completed baroclinic steps (iic)"
        self._iic = vi
        self._vars = {}
        self.f = f

        for attr, name, loc in _CORE:
            info = REGISTRY.get(name)
            self._defvar(name, loc, info.long_name, info.units)
        for trc in _tracer_names(cfg):
            info = REGISTRY.get(trc)
            self._defvar(trc, "r3", info.long_name if info else trc,
                         info.units if info else "")
            self._defvar(trc + "_prev", "r3",
                         f"{trc} at previous time level (perfect restart)")
        for name in _HIST2:
            self._defvar(name, "r2", f"{name} 2D coupling history "
                         "(perfect restart)")
        for name in _HIST3:
            self._defvar(name, "r3", f"{name} (perfect restart)")
        self._defvar("z_w", "w3", "interface depths consumed by correctors")
        self.has_mix = False

    def _defvar(self, name, loc, long_name="", units=""):
        v = self.f.createVariable(name, _nc_code(self.cfg.dtype),
                                  ("ocean_time",) + dims_for(loc, self.cfg.N))
        if long_name:
            v.long_name = long_name
        if units:
            v.units = units
        self._vars[name] = v

    def _ensure_mix_vars(self, mix):
        """Define the turbulence fields (classic NetCDF takes no new
        variable after the first record, so callers pass the initial
        state's mix before writing)."""
        if self.has_mix or mix is None:
            return
        for name in _MIX_FIELDS:
            val = getattr(mix, name)
            if val.ndim == 4:          # Akt: (NAT, N+1, Mj, Li)
                for ia in range(val.shape[0]):
                    self._defvar(f"mix_{name}{ia}", "w3")
            else:
                self._defvar(f"mix_{name}", "w3")
        self.has_mix = True

    def write(self, state: State):
        self._ensure_mix_vars(state.mix)
        i = self.nrec % self.cycle if self.cycle else self.nrec
        self._time[i] = float(state.time)
        self._iic[i] = int(state.iic)

        vals = {}
        for attr, name, _ in _CORE:
            vals[name] = getattr(state, attr)
        for it, trc in enumerate(_tracer_names(self.cfg)):
            vals[trc] = state.t[it]
            vals[trc + "_prev"] = state.t_prev[it]
        for name in _HIST2 + _HIST3:
            vals[name] = getattr(state, name)
        vals["z_w"] = state.z_w
        if state.mix is not None:
            for name in _MIX_FIELDS:
                v = getattr(state.mix, name)
                if v.ndim == 4:
                    for ia in range(v.shape[0]):
                        vals[f"mix_{name}{ia}"] = v[ia]
                else:
                    vals[f"mix_{name}"] = v

        for name, val in vals.items():
            self._vars[name][i] = host(val)
        self.nrec += 1
        self.f.flush()

    def close(self):
        self.f.close()


def read_restart(path: str, cfg: ModelConfig, grid,
                 template: State | None = None, rec: int = -1) -> State:
    """get_state.F analog: rebuild a State from a restart record on the
    grid's device.  Every field keeps the file's dtype, so stepping the
    result matches an uninterrupted run bit for bit.  `template`
    supplies the GLS/MY2.5 mix structure (a state whose mix is None
    reads none); rec -1 is the record of the latest step under
    cycling."""
    from ..core.gls import MixState
    dev = grid.device
    with netcdf_file(path, "r", mmap=False) as f:
        nrec = f.variables["ocean_time"].shape[0]
        times = native(f.variables["ocean_time"][:nrec])
        iics = native(f.variables["nsteps"][:nrec])
        if rec == -1:
            rec = int(np.argmax(iics))     # latest record under cycling

        def get(name):
            return torch.from_numpy(native(f.variables[name][rec])).to(dev)

        tn = _tracer_names(cfg)
        t = torch.stack([get(trc) for trc in tn])
        t_prev = torch.stack([get(trc + "_prev") for trc in tn])
        mix = template.mix if template is not None else None
        if mix is not None and "mix_tke" in f.variables:
            kw = {}
            for name in _MIX_FIELDS:
                ref = getattr(mix, name)
                if ref.ndim == 4:
                    kw[name] = torch.stack([get(f"mix_{name}{ia}")
                                            for ia in range(ref.shape[0])])
                else:
                    kw[name] = get(f"mix_{name}")
            mix = MixState(**kw)
        return State(
            time=float(times[rec]), iic=int(iics[rec]),
            zeta=get("zeta"), ubar=get("ubar"), vbar=get("vbar"),
            u=get("u"), v=get("v"), t=t, t_prev=t_prev,
            ru_prev=get("ru_prev"), rv_prev=get("rv_prev"),
            ru_prev2=get("ru_prev2"), rv_prev2=get("rv_prev2"),
            ru0_prev=get("ru0_prev"), rv0_prev=get("rv0_prev"),
            ru0_prev2=get("ru0_prev2"), rv0_prev2=get("rv0_prev2"),
            z_r=get("z_r"), z_w=get("z_w"), Hz=get("Hz"), mix=mix)
