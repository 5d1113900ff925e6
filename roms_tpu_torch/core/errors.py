"""Execution error taxonomy and provenance (a copy of
roms_tpu/core/errors.py, which imports no JAX; the port imports nothing
of roms_tpu).

Mirrors the reference's exit_flag codes (mod_scalars.F:548-565) and the
FoundError/__FILE__/__LINE__ provenance discipline every reference call
site uses (e.g. Drivers/nl_roms.h:89,139).  Numerical failures
(blowup) surface as an integer code in core/diag.py's Diagnostics;
host-side failures (I/O, config, input) raise RomsError carrying the
same code plus call-site provenance.
"""

from __future__ import annotations

import enum
import inspect
import os


class ExitFlag(enum.IntEnum):
    """mod_scalars.F:548-559 taxonomy."""

    NO_ERROR = 0
    BLOWS_UP = 1
    INPUT_ERROR = 2
    OUTPUT_ERROR = 3
    IO_ERROR = 4
    CONFIG_ERROR = 5
    PARTITION_ERROR = 6
    ILLEGAL_INPUT = 7
    FATAL_ALGORITHM = 8
    COUPLING_ERROR = 9


_MESSAGES = {
    ExitFlag.NO_ERROR: "No error",
    ExitFlag.BLOWS_UP: "Blows up",
    ExitFlag.INPUT_ERROR: "Input error",
    ExitFlag.OUTPUT_ERROR: "Output error",
    ExitFlag.IO_ERROR: "IO error",
    ExitFlag.CONFIG_ERROR: "Configuration error",
    ExitFlag.PARTITION_ERROR: "Partition error",
    ExitFlag.ILLEGAL_INPUT: "Illegal input parameter",
    ExitFlag.FATAL_ALGORITHM: "Fatal algorithm result",
    ExitFlag.COUPLING_ERROR: "coupling error",
}


class RomsError(RuntimeError):
    """Host-side failure with exit_flag code and file:line provenance."""

    def __init__(self, flag: ExitFlag, detail: str = "",
                 provenance: str | None = None):
        self.exit_flag = ExitFlag(flag)
        if provenance is None:
            frame = inspect.stack()[1]
            provenance = (f"{os.path.basename(frame.filename)}"
                          f":{frame.lineno}")
        self.provenance = provenance
        msg = f"[exit_flag={int(flag)}] {_MESSAGES[self.exit_flag]}"
        if detail:
            msg += f": {detail}"
        msg += f"  (found at {provenance})"
        super().__init__(msg)

