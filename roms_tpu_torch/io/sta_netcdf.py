"""NetCDF station stream + stations input-deck parser (port of
roms_tpu/io/sta_netcdf.py).

The reference extracts time series at fixed locations through
def_station.F/wrt_station.F, with the station list and `Sout(...)`
field switches read from a separate stations deck (SPOSNAM ->
ROMS/External/stations_*.in: `NSTATION ==`, a `POS =` table of
GRID/FLAG/X-POS/Y-POS rows, read by read_stapar.F).  This module is
both halves for the port:

  * ``parse_stations_in`` — the deck reader: NSTATION, the POS rows
    (FLAG=0 grid-index pairs are used directly; FLAG=1 lon/lat rows are
    returned for the caller to map), and the Sout switches;
  * ``StationWriter`` — the stream: an unlimited ocean_time NetCDF
    with a `station` dimension, per-station (Ipos, Jpos) coordinates,
    and one record variable per selected field (profiles carry s_rho).

StationWriter gathers through io/stations.py's `StationRecorder`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.io import netcdf_file

from ..config import ModelConfig
from .stations import StationRecorder

_POS_ROW = re.compile(
    r"^\s*(\d+)\s+([01])\s+([-\d.Ee+]+)\s+([-\d.Ee+]+)")


def parse_stations_in(path: str) -> Dict:
    """Parse a reference stations deck (read_stapar.F semantics).

    Returns {"nstation", "pos": [(grid, flag, x, y), ...],
    "sout": {id: bool}}; FLAG=0 rows are (I, J) fractional grid
    indices, FLAG=1 rows are (lon, lat).
    """
    nstation = 0
    pos: List[Tuple[int, int, float, float]] = []
    sout: Dict[str, bool] = {}
    in_pos = False
    for raw in open(path, errors="replace"):
        line = raw.split("!")[0].rstrip()
        if not line.strip():
            continue
        m = re.match(r"\s*NSTATION\s*==\s*(\d+)", line)
        if m:
            nstation = int(m.group(1))
            continue
        m = re.match(r"\s*Sout\((\w+)\)\s*==\s*([TF])", line)
        if m:
            sout[m.group(1)] = m.group(2) == "T"
            continue
        if line.strip().startswith("POS ="):
            in_pos = True
            continue
        if in_pos:
            m = _POS_ROW.match(line)
            if m:
                pos.append((int(m.group(1)), int(m.group(2)),
                            float(m.group(3)), float(m.group(4))))
            if nstation and len(pos) >= nstation:
                in_pos = False
    return {"nstation": nstation or len(pos), "pos": pos, "sout": sout}


class StationWriter:
    """def_station.F/wrt_station.F analog: NetCDF STA stream.

    stations: sequence of (j, i) integer grid locations (FLAG=0 rows of
    the deck, rounded).  Fields follow StationRecorder's conventions;
    3-D fields get (ocean_time, s_rho, station) records.
    """

    def __init__(self, path: str, cfg: ModelConfig,
                 stations: Sequence[Tuple[int, int]], fields):
        self.cfg = cfg
        Mj, Li = cfg.shape2d
        # read_stapar.F validates positions against the grid; stations
        # outside this domain are dropped
        stations = [s for s in stations
                    if 0 <= s[0] < Mj and 0 <= s[1] < Li]
        if not stations:
            raise ValueError("no stations inside the model domain")
        self.rec = StationRecorder(cfg, stations, fields)
        self.nrec = 0
        ns = len(stations)
        f = netcdf_file(path, "w", version=2)
        f.type = "ROMS/TOMS station file"
        f.createDimension("ocean_time", None)
        f.createDimension("station", ns)
        f.createDimension("s_rho", cfg.N)
        vt = f.createVariable("ocean_time", "d", ("ocean_time",))
        vt.units = "seconds since initialization"
        self._time = vt
        vi = f.createVariable("Ipos", "i", ("station",))
        vj = f.createVariable("Jpos", "i", ("station",))
        vi[:] = np.asarray([s[1] for s in stations], np.int32)
        vj[:] = np.asarray([s[0] for s in stations], np.int32)
        self._vars = {}
        for name in fields:
            dims = ("ocean_time", "station") if name in (
                "zeta", "ubar", "vbar") else ("ocean_time", "s_rho",
                                              "station")
            self._vars[name] = f.createVariable(name, "f", dims)
        self.f = f

    def write(self, state) -> None:
        i = self.nrec
        self._time[i] = float(state.time)
        for name, val in self.rec.sample(state).items():
            self._vars[name][i] = np.asarray(val, np.float32)
        self.nrec += 1
        self.f.flush()

    def close(self) -> None:
        self.f.close()
