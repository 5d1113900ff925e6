"""NetCDF history and average streams (port of roms_tpu/io/netcdf.py).

The reference writes NetCDF through a rank-0 gather (def_his.F/wrt_his.F
via nf_fwrite2d/3d + mp_gather).  Here each field of a record is copied
from the device to the host once, at the record, and appended to a
classic NetCDF file through scipy.io.netcdf_file, with roms_tpu's schema:
ocean_time unlimited record dimension, s_rho/s_w vertical coordinates
with Vtransform/Vstretching attributes, staggered eta/xi dimensions per
C-grid location, and float32 records.

The derived fields rho, omega and w are formed as roms_tpu's writer forms
them (rho_eos, set_massflux, omega, wvelocity), each on the route the
port's step gives it: the EOS through kernel 1's wrapper, and the mass
fluxes with omega through kernel 7's where its class covers the
configuration (core/omega.py `mass_flux_omega`, which core/diag.py
shares).  The AVG
stream's running sums stay on the device between writes.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.io import netcdf_file

from ..config import ModelConfig
from ._ncutil import tracer_names
from .varinfo import REGISTRY, dims_for, varinfo_for

_DIAGNOSED = ("sustr", "svstr", "shflux", "ssflux", "swrad", "bustr",
              "bvstr", "hsbl", "hbbl", "lwrad", "latent", "sensible",
              "evaporation", "rain", "EminusP", "Pair", "Tair",
              "Uwind", "Vwind")


def host(x) -> np.ndarray:
    """A tensor (or array) as a host numpy array of its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def supported_keys(cfg: ModelConfig, model) -> set:
    """Every registry key the writers can extract for this configuration
    (wrt_his.F field dispatch), the write-time diagnostics of
    `model.diagnose` (forcing, bottom stress, mixing coefficients, KPP
    depth) included."""
    keys = {"zeta", "ubar", "vbar", "u", "v", "rho", "w", "omega",
            "u_sur", "v_sur"}
    tn = tracer_names(cfg)
    keys |= set(tn)
    keys |= {f"{n}_sur" for n in tn}
    if cfg.mixing.vmix in ("gls", "my25"):
        keys |= {"tke", "gls", "AKv", "AKt", "AKk", "Lscale"}
        if cfg.NT > 1:
            keys.add("AKs")
    keys |= {"sustr", "svstr", "shflux", "swrad", "bustr", "bvstr"}
    if cfg.NT > 1:
        keys.add("ssflux")
    if hasattr(getattr(model, "forcing_fn", None), "components"):
        keys |= {"lwrad", "latent", "sensible", "evaporation", "rain",
                 "EminusP", "Pair", "Tair", "Uwind", "Vwind"}
    if cfg.mixing.vmix not in ("gls", "my25"):
        keys |= {"AKv", "AKt"}
        if cfg.NT > 1:
            keys.add("AKs")
        if cfg.mixing.vmix == "lmd":
            keys.add("hsbl")
            if cfg.mixing.bkpp:
                keys.add("hbbl")
    return keys


class HistoryWriter:
    """Append-per-record NetCDF writer (HIS/QCK streams).

    fields: registry keys written each record.  Tracer keys map through
    the cfg tracer-name table to state.t slices; turbulence fields come
    from state.mix; forcing/stress/mixing diagnostics from
    `model.diagnose`, and the derived fields on the model's routes.
    """

    def __init__(self, path: str, cfg: ModelConfig, grid, fields, model):
        self.cfg = cfg
        self.grid = grid
        self.fields = fields
        self.model = model
        self.use_kernels = model.use_kernels
        self.nrec = 0
        self._derived_for = self._diag_for = None
        Mj, Li = cfg.shape2d
        N = cfg.N
        f = netcdf_file(path, "w", version=2)
        f.history = "roms_tpu_torch history file"
        f.type = "ROMS/TOMS history file"
        f.Vtransform = cfg.vert.Vtransform
        f.Vstretching = cfg.vert.Vstretching

        # scipy's classic-format writer requires the record dimension
        # to be defined first
        f.createDimension("ocean_time", None)
        f.createDimension("xi_rho", Li)
        f.createDimension("xi_u", Li)
        f.createDimension("xi_v", Li)
        f.createDimension("eta_rho", Mj)
        f.createDimension("eta_u", Mj)
        f.createDimension("eta_v", Mj)
        f.createDimension("s_rho", N)
        f.createDimension("s_w", N + 1)

        vt = f.createVariable("ocean_time", "d", ("ocean_time",))
        vt.units = "seconds since initialization"
        self._time = vt

        for name in ("s_rho", "s_w", "Cs_r", "Cs_w"):
            dim = "s_rho" if name.endswith("_r") or name == "s_rho" \
                else "s_w"
            v = f.createVariable(name, "d", (dim,))
            src = {"s_rho": grid.sc_r, "s_w": grid.sc_w,
                   "Cs_r": grid.Cs_r, "Cs_w": grid.Cs_w}[name]
            v[:] = host(src).astype(np.float64)

        # static grid fields
        for key in ("h", "f", "pm", "pn"):
            info = REGISTRY[key]
            v = f.createVariable(info.name, "d", dims_for(info.location, N))
            v.long_name = info.long_name
            v.units = info.units
            v[:] = host(getattr(grid, key)).astype(np.float64)

        self._vars = {}
        for key in self.fields:
            info = varinfo_for(key)
            dims = ("ocean_time",) + dims_for(info.location, N)
            v = f.createVariable(info.name, "f", dims)
            v.long_name = info.long_name
            v.units = info.units
            self._vars[key] = v
        self.f = f

    def _derived(self, s):
        """rho (rho_eos), omega = W*pm*pn (scale_omega, wrt_his.F:
        992-1006) and the true vertical velocity w (wvelocity.F), whose
        barotropic means are the vertical integrals of the mass fluxes
        of the state's u and v."""
        from ..core.omega import mass_flux_omega, wvelocity
        from ..core.rho_eos import rho_eos
        cfg, grid, kern = self.cfg, self.grid, self.use_kernels
        rho = rho_eos(cfg, s.t, s.z_r, s.Hz, s.z_w, use_kernels=kern)[0]
        Huon, Hvom, W = mass_flux_omega(cfg, grid, s.u, s.v, s.Hz, s.z_w,
                                        kern)
        wvel = wvelocity(cfg, grid, s.u, s.v, W, s.z_r, s.z_w,
                         Huon.sum(0), Hvom.sum(0))
        return {"rho": rho, "omega": W * (grid.pm * grid.pn)[None],
                "w": wvel}

    def _diagnosed(self, state):
        """model.diagnose output, one evaluation per state."""
        if self._diag_for is not state:
            self._diag_vals = self.model.diagnose(state)
            self._diag_for = state
        return self._diag_vals

    def _extract(self, state, key):
        """The field `key` of `state` as a tensor on its device."""
        if key in ("rho", "w", "omega"):
            # one derived-field evaluation per state, not per key
            if self._derived_for is not state:
                self._derived_vals = self._derived(state)
                self._derived_for = state
            return self._derived_vals[key]
        if key.endswith("_sur"):
            return self._extract(state, key[:-4])[-1]
        tn = tracer_names(self.cfg)
        if key in tn:
            return state.t[tn.index(key)]
        mix = state.mix
        if mix is not None:
            if key in ("tke", "gls", "Lscale"):
                return getattr(mix, key)
            if key == "AKk":
                return mix.Akk
            if key == "AKv":
                return mix.Akv
            if key == "AKt":
                return mix.Akt[0]
            if key == "AKs":
                return mix.Akt[1]
        if key in _DIAGNOSED or key in ("AKv", "AKt", "AKs"):
            return self._diagnosed(state)[key]
        return getattr(state, key)

    def write(self, state):
        i = self.nrec
        self._time[i] = float(state.time)
        for key in self.fields:
            self.write_field(i, key, self._extract(state, key))
        self.nrec += 1
        self.f.flush()

    def write_field(self, i, key, val):
        """Record i of field `key` from a tensor, as float32."""
        self._vars[key][i] = host(val).astype(np.float32)

    def close(self):
        self.f.close()


class AverageAccumulator:
    """Time-averaged output (set_avg.F / AVG stream): running sums of the
    selected fields between writes, kept on the state's device."""

    def __init__(self, cfg: ModelConfig, fields):
        self.cfg = cfg
        self.fields = fields
        self.reset()

    def reset(self):
        self._sum = None
        self._count = 0

    def accumulate(self, extract_fn, state):
        vals = {k: extract_fn(state, k) for k in self.fields}
        if self._sum is None:
            self._sum = {k: v.clone() for k, v in vals.items()}
        else:
            for k in self.fields:
                self._sum[k] = self._sum[k] + vals[k]
        self._count += 1

    def mean(self):
        return {k: v / self._count for k, v in self._sum.items()}
