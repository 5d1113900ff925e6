"""Station gathers (port of roms_tpu/io/stations.py; STA stream,
def_station.F/wrt_station.F).

Stations are fixed (j, i) grid locations; each sample gathers the
selected fields at those points on the device and copies only the
gathered values to the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig


class StationRecorder:
    def __init__(self, cfg: ModelConfig, stations: Sequence[Tuple[int, int]],
                 fields):
        self.cfg = cfg
        self.jj = np.array([s[0] for s in stations])
        self.ii = np.array([s[1] for s in stations])
        self._index = {}
        self.fields = fields

    def _at_stations(self, arr):
        dev = arr.device
        if dev not in self._index:
            self._index[dev] = (torch.as_tensor(self.jj, device=dev),
                                torch.as_tensor(self.ii, device=dev))
        jj, ii = self._index[dev]
        return arr[..., jj, ii].cpu().numpy()

    def sample(self, state):
        """{field: its values at the stations} of one state."""
        out = {}
        for f in self.fields:
            if f == "temp":
                arr = state.t[0]
            elif f == "salt":
                arr = state.t[1]
            else:
                arr = getattr(state, f)
            out[f] = self._at_stations(arr)
        return out
