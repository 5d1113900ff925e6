"""Kernel 3: fused 3D momentum right-hand side (csrc/rhs3d.cu): one CUDA
block per tile of columns marching k, each level's fields and face
fluxes in shared memory.

Replaces roms_tpu/ops/pallas_rhs3d.py `rhs3d_momentum_pallas`.  Output
ring rows j = 0 and Mj-1 are zero in both the kernel and its plain
version; bc_u/bc_v overwrite them downstream.  Closed or EW-periodic
lanes; `covers` is the class of roms_tpu/core/rhs3d.py
`_use_pallas_rhs3d`.
"""

from __future__ import annotations

import torch

from . import _lib


# the tile (rows, lanes): at most THREADS points, one a thread of the
# block; (8, 32) is among the fastest of the tiles `chip_smoke.py
# --profile` times on the H100 at both full-width shapes (PERF.md)
TILE = (8, 32)
THREADS = 256
HALO = 2           # window rows and lanes beyond the tile (csrc kHalo)
WINDOW_PLANES = 19  # window planes in shared memory (csrc Smem)


def launch_shape(Mj: int, Li: int, itemsize: int):
    """(TJ, TI, halo, blocks, dynamic shared memory bytes) of the kernel's
    launch (csrc/rhs3d.cu): the tile evened out over the grid, its window
    planes and the tables of window rows and lanes.  A tile of fewer than
    five lanes is widened (up to the grid's width): the lane tiling is
    shifted by TI // 2, and the periodic seam's ring positions stay in
    the seam's tile only if it reaches two lanes west and three east of
    the seam."""
    TJ, TI, blocks = _lib.seam_tiles(Mj, Li, TILE)
    WJ, WI = TJ + 2 * HALO, TI + 2 * HALO
    smem = itemsize * WINDOW_PLANES * WJ * WI + 4 * (3 * WJ + 4 * WI)
    return TJ, TI, HALO, blocks, smem


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
    return _launch(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv)


def _launch(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv):
    if not covers(cfg) or (cfg.uv_adv and cfg.uv_vadv != "c4_sw"):
        raise NotImplementedError(
            "rhs3d kernel covers UP3/C4_SW on non-NS-periodic grids")
    ins, sfx, stream = _lib.prepare(
        "rhs3d_momentum", [u, v, Hz, Huon, Hvom, W, ru, rv, grid.fomn,
                           grid.dndx, grid.dmde])
    u = ins[0]
    N, Mj, Li = u.shape
    if W.shape != (N + 1, Mj, Li) or N < 3 or Mj < 3 or \
            Li < (4 if cfg.bc.ew_periodic else 3) or \
            any(x.shape != u.shape for x in ins[1:5] + ins[6:8]):
        raise ValueError("rhs3d_momentum: inconsistent shapes")
    TJ, TI, _, _, smem = launch_shape(Mj, Li, u.element_size())
    if smem > _lib.SMEM_PER_BLOCK or TJ * TI > THREADS:
        raise ValueError(f"rhs3d_momentum: a {TJ}x{TI} tile needs {smem} B "
                         f"of shared memory (at most 227 KB) and {TJ * TI} "
                         f"threads (at most {THREADS})")
    out_u = torch.empty_like(u)
    out_v = torch.empty_like(u)
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_rhs3d_{sfx}", [P] * 13 + [I] * 9 + [P])
    rc = fn(*[_lib.ptr(x) for x in ins + [out_u, out_v]],
            N, Mj, Li, int(bool(cfg.uv_cor)), int(bool(cfg.curvgrid)),
            int(bool(cfg.uv_adv)), int(cfg.bc.ew_periodic), TJ, TI,
            P(stream))
    _lib.launches["rhs3d_momentum"] += 1
    _lib.check(rc, "rhs3d_momentum")
    return out_u, out_v
