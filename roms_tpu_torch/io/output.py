"""Per-step output dispatcher (port of roms_tpu/io/output.py; output.F
analog).

The reference's `output` routine (ROMS/Utility/output.F:3-755) runs once
per baroclinic step and decides, from the cadence keywords of the input
deck (NHIS/NQCK/NAVG/NDIA/NRST, roms_upwelling.in), which streams get a
record: define-on-first-touch, HIS/QCK snapshots, AVG running means
(set_avg.F) and the cycling RST stream, plus the STA stations stream and
the NINFO energy table.  `OutputManager` is that dispatcher, with
roms_tpu's cadences, file names, `unsupported` report and NINFO lines:
construct it from the dict of `io.roms_in.parse_roms_in`, then call
`.step(state)` after each step that ends on an output event.

Field selection follows the deck's `Hout(id...)`/`Qout(...)`/`Aout(...)`
switches, translated to registry keys through the `index_code` column of
io/varinfo.py (mod_ncparam id names).  Ids the writers cannot extract
are collected in `self.unsupported` rather than dropped silently.  A
deck with NDIA asks for the DIA budget streams: `wants_diag` /
`wants_diag_uv` send the driver to Model.step_diag / step_diag_uv, which
raise until the budgets are ported (ROADMAP Queue 1 item 10).

Tensors are copied to the host only at output events: a record, a NINFO
line, a station sample.  The AVG sums stay on the device.
"""

from __future__ import annotations

import os
import re
from typing import Dict

from ..config import ModelConfig
from ._ncutil import tracer_names
from .netcdf import AverageAccumulator, HistoryWriter, supported_keys
from .rst_netcdf import RestartWriter
from .varinfo import REGISTRY

# quick-stream surface-slice ids (wrt_quick.F idSur* switches)
_SURFACE_CODES = {"idSurT": "temp_sur", "idSurS": "salt_sur",
                  "idSurU": "u_sur", "idSurV": "v_sur",
                  "idUsur": "u_sur", "idVsur": "v_sur"}


def _fields_from_switches(params: Dict, prefix: str, cfg, supported):
    """Hout(idFsur)=True ... -> tuple of registry keys, skipping ids the
    writers cannot extract (returned separately).

    The id->key map is driven by the registry index codes plus the cfg
    tracer-name table for the per-tracer idTvar list (mod_ncparam
    semantics: Hout(idTvar) carries one flag per tracer in deck
    order)."""
    by_code: Dict[str, list] = {}
    for key, info in REGISTRY.items():
        if info.index_code and info.index_code != "idTvar":
            by_code.setdefault(info.index_code, []).append(key)
    by_code["idTvar"] = list(tracer_names(cfg))
    for code, key in _SURFACE_CODES.items():
        by_code.setdefault(code, [key])
    fields, unsupported = [], []
    pat = re.compile(rf"^{prefix}\((\w+)\)$")
    any_switch = False
    for key, val in params.items():
        m = pat.match(key)
        if not m:
            continue
        any_switch = True
        code = m.group(1)
        keys = by_code.get(code, [])
        flags = val if isinstance(val, list) else [val] * max(len(keys),
                                                              1)
        if not keys:
            if (val is True) or (isinstance(val, list) and any(val)):
                unsupported.append(code)
            continue
        # per-tracer flag lists can be longer than the registry's
        # tracer keys; the overflow is unsupported, not dropped
        for on in flags[len(keys):]:
            if on:
                unsupported.append(code)
        for k, on in zip(keys, flags):
            if on and k in supported:
                fields.append(k)
            elif on:
                unsupported.append(f"{code}:{k}")
    return tuple(fields), unsupported, any_switch


class OutputManager:
    """Cadence-driven stream dispatcher for HIS/QCK/AVG/RST/STA/NINFO.

    params: the parsed roms_*.in dict; its cadences, file names and
    field switches decide every stream.  A stream writes when
    ``state.iic % cadence == 0`` (records at step N, 2N, ...), the
    reference's end-of-step output call.
    """

    def __init__(self, cfg: ModelConfig, grid, params: Dict, outdir: str,
                 initial_state, model):
        self.cfg = cfg
        self.grid = grid
        self.model = model
        self.unsupported: list = []
        self._supported = supported_keys(cfg, model)

        def cad(key):
            return int(params.get(key, 0) or 0)

        self.nhis = cad("NHIS")
        self.nqck = cad("NQCK")
        self.navg = cad("NAVG")
        self.nrst = cad("NRST")
        self.ndia = cad("NDIA")

        def path(key, default):
            return os.path.join(outdir, params.get(key, default))

        def pick(prefix, fallback):
            # a deck WITH switches rules, even if it disables every
            # field (time-only stream); the fallback applies only when
            # the deck carries no switches for this stream at all
            f, unsup, any_switch = _fields_from_switches(
                params, prefix, cfg, self._supported)
            self.unsupported += unsup
            return f if any_switch else fallback

        default_fields = ("zeta", "ubar", "vbar", "u", "v", "temp", "salt")
        self.his = self.qck = self.avg_writer = self.rst = None
        self.avg = None
        if self.nhis:
            self.his = HistoryWriter(
                path("HISNAME", "roms_his.nc"), cfg, grid,
                fields=pick("Hout", default_fields), model=model)
        if self.nqck:
            self.qck = HistoryWriter(
                path("QCKNAME", "roms_qck.nc"), cfg, grid,
                fields=pick("Qout", ("zeta", "temp_sur", "u_sur",
                                     "v_sur")), model=model)
        if self.navg:
            afields = pick("Aout", default_fields)
            self.avg_writer = HistoryWriter(
                path("AVGNAME", "roms_avg.nc"), cfg, grid,
                fields=afields, model=model)
            self.avg = AverageAccumulator(cfg, afields)
            self._avg_t0 = None
        # DIA streams (def_diags.F/wrt_diags.F): the tracer budgets with
        # NDIA, the momentum budgets when a Dout(M2*/M3*) switch is on
        self.wants_diag = bool(self.ndia)
        self.wants_diag_uv = self.wants_diag and any(
            re.match(r"^Dout\(M[23]\w+\)$", k) and (
                v is True or (isinstance(v, list) and any(v)))
            for k, v in params.items())
        if self.nrst:
            cycle = 2 if params.get("LcycleRST", True) else 0
            self.rst = RestartWriter(
                path("RSTNAME", "roms_rst.nc"), cfg, grid, cycle=cycle)
            # define the mix_* schema up-front (classic NetCDF cannot
            # add variables after the first record)
            self.rst._ensure_mix_vars(initial_state.mix)
        # STA stream from the stations deck (SPOSNAM + NSTA cadence)
        self.nsta = cad("NSTA")
        self.sta = None
        spos = params.get("SPOSNAM")
        if self.nsta and spos and os.path.exists(spos):
            from .sta_netcdf import StationWriter, parse_stations_in
            deck = parse_stations_in(spos)
            ij = [(int(round(y)), int(round(x)))
                  for g, flag, x, y in deck["pos"] if flag == 0]
            # the station recorder gathers prognostic fields only
            ok = {"zeta", "ubar", "vbar", "u", "v", "temp", "salt"}
            sta_fields, unsup, any_sw = _fields_from_switches(
                {f"Sout({k})": v for k, v in deck["sout"].items()},
                "Sout", cfg, ok)
            self.unsupported += unsup
            if ij:
                self.sta = StationWriter(
                    path("STANAME", "roms_sta.nc"), cfg, ij,
                    fields=sta_fields or ("zeta", "temp", "salt",
                                          "u", "v"))
        # per-step stdout diagnostics table (diag.F:440-486, NINFO)
        self.ninfo = cad("NINFO")
        self._info_header = False

    def cadences(self):
        """The nonzero cadences of the streams that write on steps that
        are multiples of them (the driver's chunk is their gcd)."""
        return [c for c in (self.nhis, self.nqck, self.nrst, self.nsta,
                            self.ninfo) if c]

    def _info(self, state) -> None:
        """Print one reference-style global-diagnostics line:
        TIME-STEP  KINETIC_ENRG  POTEN_ENRG  TOTAL_ENRG  NET_VOLUME
        plus the Courant/speed detail line (diag.F:448-486)."""
        import sys

        from ..core.diag import blowup_string, diag as diag_fn
        d = diag_fn(self.cfg, self.grid, state,
                    use_kernels=self.model.use_kernels)
        if not self._info_header:
            self._info_header = True
            print(f"{'TIME-STEP':>10s} {'KINETIC_ENRG':>14s} "
                  f"{'POTEN_ENRG':>14s} {'TOTAL_ENRG':>14s} "
                  f"{'NET_VOLUME':>14s}")
            print(f"{'':>10s} {'Cu+Cv+Cw':>14s} {'Cw':>14s} "
                  f"{'Max Speed':>14s}")
        ke = float(d.avgke)
        pe = float(d.avgpe)
        print(f"{int(state.iic):>10d} {ke:14.6E} {pe:14.6E} "
              f"{ke + pe:14.6E} {float(d.volume):14.6E}")
        print(f"{'':>10s} {float(d.max_courant):14.6E} "
              f"{float(d.max_courant_w):14.6E} "
              f"{float(d.max_speed):14.6E}")
        if int(d.exit_flag) != 0:
            print("Blowing-up:", blowup_string(d), file=sys.stderr)

    def step(self, state) -> None:
        """Dispatch all due streams for a just-completed step."""
        iic = int(state.iic)
        t = float(state.time)
        if self.ninfo and iic % self.ninfo == 0:
            self._info(state)
        if self.avg is not None:
            if self._avg_t0 is None:
                self._avg_t0 = t
            self.avg.accumulate(self.avg_writer._extract, state)
            if iic % self.navg == 0 and self.avg._count:
                mean = self.avg.mean()
                w = self.avg_writer
                i = w.nrec
                # record time = center of the averaging window
                # (set_avg.F AVGtime semantics)
                w._time[i] = 0.5 * (self._avg_t0 + t)
                for key in w.fields:
                    w.write_field(i, key, mean[key])
                w.nrec += 1
                w.f.flush()
                self.avg.reset()
                self._avg_t0 = None
        if self.his is not None and iic % self.nhis == 0:
            self.his.write(state)
        if self.qck is not None and iic % self.nqck == 0:
            self.qck.write(state)
        if self.rst is not None and iic % self.nrst == 0:
            self.rst.write(state)
        if self.sta is not None and iic % self.nsta == 0:
            self.sta.write(state)

    def close(self) -> None:
        for w in (self.his, self.qck, self.avg_writer, self.rst,
                  self.sta):
            if w is not None:
                w.close()
