"""roms_tpu_torch — the PyTorch/CUDA port of the roms_tpu ocean core.

A second package beside `roms_tpu` (the JAX reference, left untouched):
the same module layout and names, written as plain PyTorch functions
on tensors with an explicit device and dtype.  Every Pallas kernel on
the ported path is a hand-written CUDA kernel for Hopper (sm_90a)
under `csrc/`, built lazily on the first CUDA call (ops/_lib.py), so
importing the package needs no compiler.

Entry points default to `device="cuda"` and raise when CUDA is absent
unless the caller asks for the CPU (`device="cpu"`), where every
kernel wrapper takes its plain PyTorch version.
"""

from . import constants
from .config import ModelConfig

__version__ = "0.1.0"
