"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; a CUDA request without a usable card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "roms_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'float64' -> torch dtype."""
    return {"float32": torch.float32, "float64": torch.float64}[str(name)]
