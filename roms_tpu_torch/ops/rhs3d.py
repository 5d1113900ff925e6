"""Kernel 3: fused 3D momentum right-hand side (csrc/rhs3d.cu).

Replaces roms_tpu/ops/pallas_rhs3d.py `rhs3d_momentum_pallas`.  Output
ring rows j = 0 and Mj-1 are zero in both the kernel and its plain
version; bc_u/bc_v overwrite them downstream.  Closed or EW-periodic
lanes; `covers` is the class of roms_tpu/core/rhs3d.py
`_use_pallas_rhs3d`.
"""

from __future__ import annotations

import torch

from . import _lib


def covers(cfg) -> bool:
    """Non-NS-periodic grids with UP3 horizontal momentum advection."""
    return not cfg.bc.ns_periodic and cfg.uv_hadv == "up3"


def rhs3d_momentum_plain(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv):
    from ..core.rhs3d import rhs3d_terms
    ru, rv = rhs3d_terms(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv)
    ru, rv = ru.clone(), rv.clone()
    for x in (ru, rv):
        x[..., 0, :] = 0.0
        x[..., -1, :] = 0.0
    return ru, rv


def rhs3d_momentum(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if u.device.type == "cpu":
        return rhs3d_momentum_plain(cfg, grid, u, v, Hz, Huon, Hvom, W,
                                    ru, rv)
    if not covers(cfg) or (cfg.uv_adv and cfg.uv_vadv != "c4_sw"):
        raise NotImplementedError(
            "rhs3d kernel covers UP3/C4_SW on non-NS-periodic grids")
    (u, v, Hz, Huon, Hvom, W, ru, rv, fomn, dndx, dmde), sfx, stream = \
        _lib.prepare("rhs3d_momentum", [u, v, Hz, Huon, Hvom, W, ru, rv,
                                        grid.fomn, grid.dndx, grid.dmde])
    N, Mj, Li = u.shape
    if W.shape != (N + 1, Mj, Li) or N < 3 or any(
            x.shape != u.shape for x in (v, Hz, Huon, Hvom, ru, rv)):
        raise ValueError("rhs3d_momentum: inconsistent shapes")
    out_u = torch.empty_like(u)
    out_v = torch.empty_like(v)
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_rhs3d_{sfx}", [P] * 13 + [I] * 7 + [P])
    rc = fn(*[_lib.ptr(x) for x in (u, v, Hz, Huon, Hvom, W, ru, rv, fomn,
                                    dndx, dmde, out_u, out_v)],
            N, Mj, Li, int(bool(cfg.uv_cor)), int(bool(cfg.curvgrid)),
            int(bool(cfg.uv_adv)), int(cfg.bc.ew_periodic), P(stream))
    _lib.launches["rhs3d_momentum"] += 1
    _lib.check(rc, "rhs3d_momentum")
    return out_u, out_v
