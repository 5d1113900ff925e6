"""Kernel 10: harmonic momentum mixing along s-surfaces (csrc/uvmix.cu):
one CUDA block per tile of columns marching k, each level's u, v and Hz
staged in shared memory and each stress component formed once a level.

Replaces roms_tpu/ops/pallas_uvmix.py `uv3dmix2_s_pallas`; the plain
version is core/hmix.py `uv3dmix2_s`.  The kernel and its plain version
agree at every point: the ring rows add the roll-wrap stress, where the
Pallas kernel leaves the seeds unchanged.  `covers` is the class of
`use_pallas_uvmix` (pallas_uvmix.py:208) with roms_tpu/core/hmix.py:58-60
(visc2 > 0, no Smagorinsky coefficients).
"""

from __future__ import annotations

import torch

from . import _lib

# the 2-D metrics the kernel reads (pallas_uvmix._G2D)
METRICS = ("pn", "pm", "pmon_r", "pnom_r", "on_r", "om_r", "pmon_p",
           "pnom_p", "on_p", "om_p", "pmask", "visc2_r", "visc2_p")

# the tile (rows, lanes): the tile grown by a row and a lane, (TJ + 1) x
# (TI + 1) positions, has a thread a position; (7, 31) was the fastest of
# the tiles `chip_smoke.py --profile` times on the H100 at both full-width
# shapes (PERF.md)
TILE = (7, 31)
THREADS = 256
HALO = 1           # window rows and lanes beyond the tile (csrc kHalo)
STAGES = 3         # level buffers of the cp.async pipeline (csrc kStages)
WINDOW_PLANES = 3 * STAGES + 4  # window planes in shared memory (csrc Smem)


def launch_shape(Mj: int, Li: int, itemsize: int):
    """(TJ, TI, blocks, dynamic shared memory bytes) of the kernel's launch
    (csrc/uvmix.cu): the tiles of `_lib.seam_tiles`, STAGES buffers of u,
    v and Hz and the four stresses on the tile's window, and the tables
    of window rows, lanes, ring lanes and positions."""
    TJ, TI, blocks = _lib.seam_tiles(Mj, Li, TILE)
    WJ, WI = TJ + 2 * HALO, TI + 2 * HALO
    smem = itemsize * WINDOW_PLANES * WJ * WI + 4 * (WJ + 2 * WI + WJ * WI)
    return TJ, TI, blocks, smem


def covers(cfg) -> bool:
    return (cfg.bc.ew_periodic and not cfg.bc.ns_periodic
            and cfg.mixing.visc2 > 0.0 and not cfg.mixing.smagorinsky)


def uv3dmix2_s_plain(cfg, grid, u, v, u_part, v_part, Hz, rufrc, rvfrc):
    from ..core.hmix import uv3dmix2_s as plain
    return plain(cfg, grid, u, v, u_part, v_part, Hz, rufrc, rvfrc)


def uv3dmix2_s(cfg, grid, u, v, u_part, v_part, Hz, rufrc, rvfrc):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors.
    Returns (u_part, v_part, rufrc, rvfrc)."""
    if u.device.type == "cpu":
        return uv3dmix2_s_plain(cfg, grid, u, v, u_part, v_part, Hz, rufrc,
                                rvfrc)
    return _launch(cfg, grid, u, v, u_part, v_part, Hz, rufrc, rvfrc)


def _launch(cfg, grid, u, v, u_part, v_part, Hz, rufrc, rvfrc):
    if not covers(cfg):
        raise NotImplementedError(
            "uv3dmix2_s kernel covers constant visc2 > 0 on EW-periodic, "
            "non-NS-periodic grids")
    ins, sfx, stream = _lib.prepare(
        "uv3dmix2_s", [u, v, Hz, u_part, v_part, rufrc, rvfrc]
        + [getattr(grid, n) for n in METRICS])
    N, Mj, Li = u.shape
    if N < 1 or any(x.shape != u.shape for x in ins[1:5]) or any(
            x.shape != (Mj, Li) for x in ins[5:]) or Li < 4:
        raise ValueError("uv3dmix2_s: inconsistent shapes")
    TJ, TI, _, smem = launch_shape(Mj, Li, u.element_size())
    if smem > _lib.SMEM_PER_BLOCK or (TJ + 1) * (TI + 1) > THREADS:
        raise ValueError(f"uv3dmix2_s: a {TJ}x{TI} tile needs {smem} B of "
                         f"shared memory (at most 227 KB) and "
                         f"{(TJ + 1) * (TI + 1)} threads (at most "
                         f"{THREADS})")
    outs = [torch.empty_like(u_part), torch.empty_like(v_part),
            torch.empty_like(rufrc), torch.empty_like(rvfrc)]
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_uv3dmix2_s_{sfx}", [P, P] + [I] * 5 + [D, P])
    rc = fn((P * len(ins))(*[x.data_ptr() for x in ins]),
            (P * 4)(*[x.data_ptr() for x in outs]), N, Mj, Li, TJ, TI,
            float(cfg.dt), P(stream))
    _lib.launches["uv3dmix2_s"] += 1
    _lib.check(rc, "uv3dmix2_s")
    return tuple(outs)
