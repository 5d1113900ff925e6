"""Kernel 9 (PERF.md's table): splines density-Jacobian pressure
gradient (csrc/prsgrd.cu): one CUDA block per tile of columns marching k
down, each column's pressure integrated once and each limited difference
formed once, in shared memory.

Replaces roms_tpu/ops/pallas_prsgrd.py `prsgrd32_pallas`; the plain
version is core/prsgrd.py `prsgrd32`.  The kernel and its plain version
agree at every point: the ring rows carry the roll-wrap values, which
the Pallas kernel zeroes.  `covers` is the class of `use_pallas_prsgrd`
(pallas_prsgrd.py:266) with the exclusions of roms_tpu/core/stepping.py
:383-385 (ice shelf; tide together with air pressure).
"""

from __future__ import annotations

import torch

from . import _lib


# the tile (rows, lanes): the tile grown by its west lane and south row,
# (TJ + 1) x (TI + 1) columns, has a thread a column; (7, 31) was among the
# fastest of the tiles `chip_smoke.py --profile` times on the H100
# (PERF.md)
TILE = (7, 31)
THREADS = 256
HALO = (2, 1)      # window rows/lanes south/west and north/east of the tile
STAGES = 3         # level buffers of the cp.async pipeline (csrc kStages)
WINDOW_PLANES = 2 * STAGES + 8  # window planes in shared memory (csrc Smem)


def launch_shape(Mj: int, Li: int, itemsize: int):
    """(TJ, TI, halo, blocks, dynamic shared memory bytes) of the kernel's
    launch (csrc/prsgrd.cu): the tile evened out over the grid, its window
    planes and the tables of window rows, lanes and positions.  A tile of
    fewer than five lanes is widened (up to the grid's width): the lane
    tiling is shifted by TI // 2, and the periodic ring positions the
    seam's tile reaches stay in its window only if it spans the seam."""
    TJ, TI, blocks = _lib.seam_tiles(Mj, Li, TILE)
    WJ, WI = TJ + sum(HALO), TI + sum(HALO)
    smem = itemsize * WINDOW_PLANES * WJ * WI + 4 * (WJ + 3 * WI + WJ * WI)
    return TJ, TI, HALO, blocks, smem


def covers(cfg, grid=None, eq_tide=None, Pair=None) -> bool:
    return (cfg.prsgrd == "djs" and cfg.bc.ew_periodic
            and not cfg.bc.ns_periodic
            and (grid is None or grid.zice is None)
            and not (eq_tide is not None and Pair is not None))


def prsgrd32_plain(cfg, grid, rho, z_r, z_w, Hz):
    from ..core.prsgrd import prsgrd32 as plain
    return plain(cfg, grid, rho, z_r, z_w, Hz)


def prsgrd32(cfg, grid, rho, z_r, z_w, Hz):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if rho.device.type == "cpu":
        return prsgrd32_plain(cfg, grid, rho, z_r, z_w, Hz)
    return _launch(cfg, grid, rho, z_r, z_w, Hz)


def _launch(cfg, grid, rho, z_r, z_w, Hz):
    if not covers(cfg, grid):
        raise NotImplementedError(
            "prsgrd32 kernel covers the djs scheme on EW-periodic, "
            "non-NS-periodic grids without an ice shelf")
    N, Mj, Li = rho.shape
    ins, sfx, stream = _lib.prepare(
        "prsgrd32", [rho, z_r, Hz, z_w[N], grid.umask, grid.vmask,
                     grid.on_u, grid.om_v])
    if z_r.shape != rho.shape or Hz.shape != rho.shape or \
            z_w.shape != (N + 1, Mj, Li) or N < 2 or Li < 4:
        raise ValueError("prsgrd32: inconsistent shapes")
    TJ, TI, _, _, smem = launch_shape(Mj, Li, rho.element_size())
    if smem > _lib.SMEM_PER_BLOCK or (TJ + 1) * (TI + 1) > THREADS:
        raise ValueError(f"prsgrd32: a {TJ}x{TI} tile needs {smem} B of "
                         f"shared memory (at most 227 KB) and "
                         f"{(TJ + 1) * (TI + 1)} threads (at most "
                         f"{THREADS})")
    ru, rv = torch.empty_like(rho), torch.empty_like(rho)
    GRho = cfg.g / cfg.rho0
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_prsgrd32_{sfx}", [P] * 10 + [I] * 5 + [D] * 3
                   + [P])
    rc = fn(*[_lib.ptr(x) for x in ins + [ru, rv]],
            N, Mj, Li, TJ, TI, cfg.g * (1.0 - cfg.sal_scalar), GRho,
            0.5 * GRho, P(stream))
    _lib.launches["prsgrd32"] += 1
    _lib.check(rc, "prsgrd32")
    return ru, rv
