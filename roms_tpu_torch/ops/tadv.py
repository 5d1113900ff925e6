"""Kernel 2: fused UP3 + C4 tracer advection of all tracers
(csrc/tadv.cu), predictor and corrector modes: one CUDA block per tile
of columns and group of tracers marching k, each level's tracers, mass
fluxes, curvatures and face fluxes in shared memory.

Replaces roms_tpu/ops/pallas_tadv.py `predictor_pallas` and
`corrector_pallas`.  Output rows j = 0 and Mj-1 are zero in both the
kernel and its plain version (the reference's jnp path leaves roll-wrap
values there; bc_rho overwrites them either way).  Closed or EW-periodic
lanes; `covers` is the class of `use_pallas_tadv` (pallas_tadv.py:300).
"""

from __future__ import annotations

import torch

from ..config import CENTERED4, UPSTREAM3
from . import _lib


# the tile (rows, lanes): at most THREADS points, one a thread of the
# block; (7, 31) puts the faces of the tile and its rim, (TJ + 1) x (TI +
# 1), one a thread too, and was among the fastest of the tiles
# `chip_smoke.py --profile` times on the H100 (PERF.md)
TILE = (7, 31)
THREADS = 256
HALO = 2           # window rows and lanes beyond the tile (csrc kHalo)
GROUP = 2          # tracers a block (csrc kGroup)
STAGES = 3         # level buffers of the cp.async pipeline (csrc kStages)


def launch_shape(NT: int, Mj: int, Li: int, itemsize: int):
    """(TJ, TI, halo, blocks, dynamic shared memory bytes) of the kernel's
    launch (csrc/tadv.cu): the tile evened out over the grid, one block a
    tile and group of up to GROUP tracers (G = min(NT, GROUP)): STAGES
    buffers of G + 2 window planes and of G + 2 values a thread, the
    masks' and the face fluxes' window planes and the tables of window
    rows, lanes and positions and of the faces.  A tile of
    fewer than five lanes is widened (up to the grid's width): the lane
    tiling is shifted by TI // 2, and the periodic seam's ring positions
    stay in the seam's tile only if it reaches two lanes west and three
    east of the seam."""
    TJ, TI, tiles = _lib.seam_tiles(Mj, Li, TILE)
    G = min(NT, GROUP)
    WJ, WI = TJ + 2 * HALO, TI + 2 * HALO
    smem = itemsize * ((STAGES * (G + 2) + 2 + 2 * G) * WJ * WI
                       + STAGES * (G + 2) * THREADS) \
        + 4 * (WJ + 2 * WI + WJ * WI + (TJ + 1) * (TI + 1))
    return TJ, TI, HALO, tiles * -(-NT // GROUP), smem


def covers(cfg) -> bool:
    """Non-NS-periodic grids with UP3/C4 advection of every tracer."""
    return not cfg.bc.ns_periodic and all(
        cfg.tracer_hadv(itrc) == UPSTREAM3
        and cfg.tracer_vadv(itrc) == CENTERED4 for itrc in range(cfg.NT))


def _zero_ring_rows(x):
    x = x.clone()
    x[..., 0, :] = 0.0
    x[..., -1, :] = 0.0
    return x


def predictor_plain(cfg, grid, t, t_prev, Huon, Hvom, W, Hz,
                    cff, cff1, cff2):
    """t_half for all tracers (pre_step3d.F:260-700), before bc_rho."""
    from ..core.advection import tracer_predictor
    return _zero_ring_rows(tracer_predictor(cfg, grid, t, t_prev, Huon,
                                            Hvom, W, Hz, cff, cff1, cff2))


def corrector_plain(cfg, grid, t_half, t_part, Huon, Hvom, W, Hz):
    """Pre-diffusion Hz-weighted tn for all tracers (step3d_t.F:
    343-1205): t_part - dt*pmn*(hdiv + vdiv), added in that order."""
    from ..core.advection import tracer_corrector
    return _zero_ring_rows(tracer_corrector(cfg, grid, t_half, t_part,
                                            Huon, Hvom, W, Hz))


def predictor(cfg, grid, t, t_prev, Huon, Hvom, W, Hz, cff, cff1, cff2):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if t.device.type == "cpu":
        return predictor_plain(cfg, grid, t, t_prev, Huon, Hvom, W, Hz,
                               cff, cff1, cff2)
    return _launch("tadv_predictor", cfg, grid, t, t_prev, Huon, Hvom, W,
                   Hz, (cff, cff1, cff2))


def corrector(cfg, grid, t_half, t_part, Huon, Hvom, W, Hz):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if t_half.device.type == "cpu":
        return corrector_plain(cfg, grid, t_half, t_part, Huon, Hvom, W,
                               Hz)
    return _launch("tadv_corrector", cfg, grid, t_half, t_part, Huon,
                   Hvom, W, Hz, (cfg.dt, 0.0, 0.0))


def _launch(name, cfg, grid, q, aux, Huon, Hvom, W, Hz, scalars):
    if not covers(cfg):
        raise NotImplementedError(
            f"{name} kernel covers UP3/C4 tracers on non-NS-periodic grids")
    ins, sfx, stream = _lib.prepare(
        name, [q, aux, Huon, Hvom, Hz, W, grid.pm, grid.pn, grid.umask,
               grid.vmask])
    q = ins[0]
    NT, N, Mj, Li = q.shape
    if ins[1].shape != q.shape or W.shape != (N + 1, Mj, Li) or N < 3 or \
            any(x.shape != (N, Mj, Li) for x in ins[2:5]):
        raise ValueError(f"{name}: inconsistent shapes")
    TJ, TI, _, _, smem = launch_shape(NT, Mj, Li, q.element_size())
    if smem > _lib.SMEM_PER_BLOCK or TJ * TI > THREADS:
        raise ValueError(f"{name}: a {TJ}x{TI} tile needs {smem} B of "
                         f"shared memory (at most 227 KB) and {TJ * TI} "
                         f"threads (at most {THREADS})")
    out = torch.empty_like(q)
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_tadv_{sfx}", [I] + [P] * 11 + [I] * 7 + [D] * 3
                   + [P])
    rc = fn(int(name == "tadv_predictor"),
            *[_lib.ptr(x) for x in ins + [out]],
            NT, N, Mj, Li, int(cfg.bc.ew_periodic), TJ, TI,
            *[float(s) for s in scalars], P(stream))
    _lib.launches[name] += 1
    _lib.check(rc, name)
    return out
