"""Kernels 11 and 12: the fast barotropic loop, nfast predictor +
corrector substeps, as two CUDA engines over one set of per-point
formulas (csrc/step2d_point.cuh).

- `fast_loop_res` (csrc/step2d.cu) replaces roms_tpu/ops/
  pallas_step2d.py `fast_loop_pallas_res`: all substeps in one call, one
  CUDA launch per half-step (predictor, corrector), each block a tile
  that runs the half-step's phases on a window, the intermediates that
  later phases read with neighbours in shared memory, the scalar table
  uploaded once.
- `fast_loop_blocked` (csrc/step2d_blocked.cu) replaces
  `fast_loop_pallas`, the j-blocked engine: one launch per chunk of
  `chunk_schedule(nfast)` substeps (KS = 2, KS = 1 for an odd
  remainder), each tile recomputing its halo on a window whose
  neighbour-read fields lie in shared memory, one CUDA block per
  resident slot looping over the tiles.

The plain version of both is core/step2d.py's substep loop.  Both return
the 16 carry fields (FastCarry); core/step2d.py's `aux_pass` finishes
the averages either way.  `covers` is `_class_ok` (pallas_step2d.py:890):
an EW-periodic channel with closed N/S walls for zeta, ubar and vbar, no
VolCons, no wet/dry.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import CLOSED, PERIODIC
from . import _lib

# (Mj, Li) grid fields the kernel reads, then rhoS, rhoA and the AB3
# histories ru0, rv0, ru0p2, rv0p2 (csrc/step2d_point.cuh enum Stat)
STATICS = ("h", "pm", "pn", "rmask", "umask", "vmask", "fomn", "dndx",
           "dmde", "on_u", "om_v", "pmon_r", "pnom_r", "pmon_p", "pnom_p",
           "on_r", "om_r", "on_p", "om_p", "pmask", "visc2_r", "visc2_p")
NPLANE = 27      # 16 carry planes + 11 scratch planes (enum Plane)
HALF_STEPS = 2   # kernel 11's CUDA launches per substep
# kernel 12's tile (rows, lanes) by element size, whose KS = 2 window fits
# a block's shared memory: in float32 the fastest of the tiles timed on
# the H100 at both full-width channel shapes (259 and 260 tiles there, two
# rounds of its 132 one-block slots; PERF.md), in float64 a window of the
# same 227 KB
TILE_BLOCKED = {4: (40, 56), 8: (16, 40)}
# kernel 12's window planes in shared memory (csrc/step2d_blocked.cu NWIN)
BLOCKED_WIN_PLANES = 10
# kernel 12's scratch fields (csrc/step2d_blocked.cu enum Scr): the
# predictor's three rhs histories and the first substep's two forcing
# planes over the points substep 0's corrector reads, the histories again
# over those of substep 1's
SCRATCH_FIELDS = (5, 3)
# kernel 11's tile by element size: float32 374 and 390 blocks at the
# two full-width channel shapes, three an SM (396 slots on the H100's 132
# SMs), the fastest of the tiles timed there (PERF.md); float64 windows
# take twice the shared memory a point
TILE_RES = {4: (16, 96), 8: (16, 64)}
# kernel 11's window planes in shared memory (csrc/step2d.cu kWin)
WIN_PLANES = 4


def covers(cfg) -> bool:
    bc = cfg.bc
    if not bc.ew_periodic or bc.ns_periodic or bc.volcons or cfg.wetdry:
        return False
    return all(lbc.west == PERIODIC and lbc.east == PERIODIC
               and lbc.south == CLOSED and lbc.north == CLOSED
               for lbc in (bc.zeta, bc.ubar, bc.vbar))


def scalar_table(nfast: int, w1, w2, iic: int) -> np.ndarray:
    """(nfast, 7) rows (first, cffA1, cffA2p, cffA2c, a1, a2, a3), each
    value computed in float64 as the plain loop computes it."""
    from ..core.step2d import ab3_coefs
    a = ab3_coefs(iic)
    rows = []
    for iif in range(1, nfast + 1):
        if iif == 1:
            rows.append((1.0, 0.0, (-1.0 / 12.0) * w2[iif], w2[iif - 1], *a))
        else:
            rows.append((0.0, w1[iif - 2],
                         (8.0 / 12.0) * w2[iif - 1] - (1.0 / 12.0) * w2[iif],
                         (5.0 / 12.0) * w2[iif - 1], *a))
    return np.array(rows, dtype=np.float64)


def fast_loop_res_plain(cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0,
                        vbar0, rufrc, rvfrc, rhoS, rhoA, ru0_prev, rv0_prev,
                        ru0_prev2, rv0_prev2, iic):
    """The plain substep loop; returns the FastCarry after nfast
    substeps."""
    from ..core.step2d import make_substeps
    return make_substeps(cfg, nfast, w1, w2, var_rho)(
        grid, zeta0, ubar0, vbar0, rufrc, rvfrc, rhoS, rhoA, ru0_prev,
        rv0_prev, ru0_prev2, rv0_prev2, iic)


def chunk_schedule(nfast: int):
    """Substeps of each kernel-12 launch: KS = 2, and one KS = 1 launch
    for an odd remainder (pallas_step2d.py:641-674)."""
    return [2] * (nfast // 2) + [1] * (nfast % 2)


def halo(ks: int, Li: int):
    """(rows, lanes) per window edge that keep a tile exact over ks
    substeps (csrc/step2d_blocked.cu): 6 points a substep, one row more
    for the wall copies, two lanes more for the periodic lanes, and on a
    grid of 4 or 5 lanes, where the periodic copies chain, two lanes
    more a substep and two more again."""
    return 6 * ks + 1, 6 * ks + 2 + (2 * ks + 2) * (Li <= 5)


def half_step_halo(Li: int):
    """(rows, lanes) per window edge that keep kernel 11's tile exact
    over one half-step: 3 points, one row more for the wall copies, two
    lanes more for the periodic lanes (`halo` for half a substep).  On a
    4-lane grid the periodic copies chain (lane Li-4 is lane 0, two lanes
    west of lane Li-2), which takes two lanes more."""
    return 3 + 1, 3 + 2 + 2 * (Li == 4)


def blocked_launch_shape(Mj: int, Li: int, itemsize: int, ks: int = 2):
    """Kernel 12's (TJ, TI, HJ, HI, blocks, dynamic shared memory bytes)
    at an (Mj, Li) grid, element size and KS (csrc/step2d_blocked.cu
    smem_bytes): tiles of about TILE_BLOCKED evened out over the grid,
    the halo of `halo`, BLOCKED_WIN_PLANES window planes and the window's
    row and lane tables."""
    TJ, TI = _lib.even_tiles(Mj, Li, TILE_BLOCKED[itemsize])
    HJ, HI = halo(ks, Li)
    WJ, WI = TJ + 2 * HJ, TI + 2 * HI
    blocks = -(-Mj // TJ) * -(-Li // TI)
    return (TJ, TI, HJ, HI, blocks,
            BLOCKED_WIN_PLANES * WJ * WI * itemsize + 4 * (WJ + WI))


def blocked_scratch(TJ: int, TI: int, Li: int):
    """Elements of device scratch one kernel-12 block keeps (KS = 2, which
    needs the most): SCRATCH_FIELDS planes over the points that substep
    q's corrector reads, 3 (2 q + 1) from each window edge less the ring
    copies' reach of one row and two lanes."""
    HJ, HI = halo(2, Li)
    WJ, WI = TJ + 2 * HJ, TI + 2 * HI
    return sum(n * (WJ - 2 * (6 * q + 2)) * (WI - 2 * (6 * q + 1))
               for q, n in enumerate(SCRATCH_FIELDS))


def res_launch_shape(Mj: int, Li: int, itemsize: int):
    """Kernel 11's (TJ, TI, HJ, HI, blocks, dynamic shared memory bytes)
    at an (Mj, Li) grid and element size (csrc/step2d.cu smem_bytes)."""
    TJ, TI = _lib.even_tiles(Mj, Li, TILE_RES[itemsize])
    HJ, HI = half_step_halo(Li)
    WJ, WI = TJ + 2 * HJ, TI + 2 * HI
    blocks = -(-Mj // TJ) * -(-Li // TI)
    return (TJ, TI, HJ, HI, blocks,
            (WIN_PLANES * WJ * WI + 2 * TJ * TI) * itemsize + 4 * (WJ + WI))


def blocked_slots(sfx: str, TJ: int, TI: int, HJ: int, HI: int):
    """Kernel 12's blocks that the card holds at once with a (TJ, TI)
    tile and (HJ, HI) halo (csrc/step2d_blocked.cu slots): the launch's
    grid when the grid has more tiles."""
    return _lib.func(f"roms_fast_loop_blocked_{sfx}_slots",
                     [_lib.I] * 4)(TJ, TI, HJ, HI)


def _kernel_inputs(name, cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0,
                   vbar0, rufrc, rvfrc, rhoS, rhoA, ru0_prev, rv0_prev,
                   ru0_prev2, rv0_prev2, iic):
    """What both engines hand their kernel: the statics (STATICS, rhoS,
    rhoA, the AB3 histories), the initial carry as 16 (Mj, Li) planes,
    the scalar table, the constants and flags, the dtype suffix and the
    stream."""
    if not covers(cfg):
        raise NotImplementedError(
            f"{name}: the fast loop kernels cover the EW-periodic channel "
            "with closed N/S walls, without VolCons or wet/dry")
    stat, sfx, stream = _lib.prepare(
        name, [getattr(grid, n) for n in STATICS]
        + [rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2, rv0_prev2])
    init, _, _ = _lib.prepare(name, [zeta0, ubar0, vbar0, rufrc, rvfrc])
    Mj, Li = zeta0.shape
    if any(x.shape != (Mj, Li) for x in stat + init) or Li < 4 or Mj < 4:
        raise ValueError(f"{name}: inconsistent shapes")
    zeta0, ubar0, vbar0, rufrc, rvfrc = init
    carry = torch.zeros((16, Mj, Li), dtype=zeta0.dtype,
                        device=zeta0.device)
    for k, x in enumerate((zeta0, zeta0, ubar0, ubar0, vbar0, vbar0)):
        carry[k].copy_(x)
    carry[9].copy_(rufrc)
    carry[10].copy_(rvfrc)
    table = torch.tensor(scalar_table(nfast, w1, w2, iic),
                         dtype=zeta0.dtype, device=zeta0.device)
    consts = (ctypes.c_double * 4)(cfg.g, cfg.rho0, cfg.dt / cfg.ndtfast,
                                   cfg.gamma2)
    flags = (int(bool(var_rho)) | int(bool(cfg.uv_adv)) << 1
             | int(bool(cfg.uv_cor)) << 2
             | int(bool(cfg.curvgrid and cfg.uv_adv)) << 3
             | int(cfg.mixing.visc2 > 0.0) << 4)
    statp = (_lib.P * len(stat))(*[x.data_ptr() for x in stat])
    return stat, statp, carry, table, consts, flags, sfx, stream


def _carry(f, ru0_prev, rv0_prev):
    from ..core.step2d import FastAverages, FastCarry
    return FastCarry(
        zeta=f[0], zeta_prev=f[1], ubar=f[2], ubar_prev=f[3], vbar=f[4],
        vbar_prev=f[5], rzeta_prev=f[6], rubar_prev=f[7], rvbar_prev=f[8],
        rufrc=f[9], rvfrc=f[10], ru0=ru0_prev, rv0=rv0_prev,
        avg=FastAverages(*f[11:16]))


def fast_loop_res(cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0, vbar0,
                  rufrc, rvfrc, rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2,
                  rv0_prev2, iic):
    """Kernel 11's wrapper: plain version on CPU tensors, kernel on CUDA
    tensors."""
    args = (cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0, vbar0, rufrc,
            rvfrc, rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2, rv0_prev2,
            iic)
    if zeta0.device.type == "cpu":
        return fast_loop_res_plain(*args)
    return _launch_res(*args)


def _launch_res(*args):
    stat, statp, carry, table, consts, flags, sfx, stream = \
        _kernel_inputs("fast_loop_res", *args)
    nfast, ru0_prev, rv0_prev = args[2], args[13], args[14]
    Mj, Li = carry.shape[1:]
    buf = torch.empty((NPLANE, Mj, Li), dtype=carry.dtype,
                      device=carry.device)
    buf[:16].copy_(carry)
    TJ, TI, HJ, HI, _, _ = res_launch_shape(Mj, Li, carry.element_size())
    final = (ctypes.c_int * 16)()
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_fast_loop_{sfx}",
                   [P, P, P, P, I, I, I, I, I, I, I, P, I, P])
    rc = fn(statp, _lib.ptr(buf), _lib.ptr(table), final, nfast, Mj, Li,
            TJ, TI, HJ, HI, consts, flags, P(stream))
    _lib.launches["fast_loop_res"] += 1
    _lib.check(rc, "fast_loop_res")
    return _carry([buf[final[k]] for k in range(16)], ru0_prev, rv0_prev)


def fast_loop_blocked(cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0,
                      vbar0, rufrc, rvfrc, rhoS, rhoA, ru0_prev, rv0_prev,
                      ru0_prev2, rv0_prev2, iic):
    """Kernel 12's wrapper: plain version (kernel 11's, since both engines
    compute one function) on CPU tensors; on CUDA tensors
    one kernel launch per chunk of `chunk_schedule(nfast)`, counted each,
    the carry ping-ponged between two 16-plane buffers, the predictor's
    rhs histories in a scratch of `blocked_scratch` elements per resident
    block.  A window over a block's shared memory raises before any
    launch."""
    args = (cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0, vbar0, rufrc,
            rvfrc, rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2, rv0_prev2,
            iic)
    if zeta0.device.type == "cpu":
        return fast_loop_res_plain(*args)
    return _launch_blocked(*args)


def _launch_blocked(*args):
    stat, statp, src, table, consts, flags, sfx, stream = \
        _kernel_inputs("fast_loop_blocked", *args)
    nfast, ru0_prev, rv0_prev = args[2], args[13], args[14]
    Mj, Li = src.shape[1:]
    TJ, TI, HJ, HI, blocks, smem = blocked_launch_shape(
        Mj, Li, src.element_size())
    if smem > _lib.SMEM_PER_BLOCK:
        raise ValueError(f"fast_loop_blocked: a {TJ}x{TI} tile's window "
                         f"needs {smem} B of shared memory (at most 227 KB)")
    P, I, L = _lib.P, _lib.I, ctypes.c_longlong
    slots = min(blocks, blocked_slots(sfx, TJ, TI, HJ, HI))
    if slots < 1:
        raise RuntimeError("fast_loop_blocked: no block fits an SM")
    per = blocked_scratch(TJ, TI, Li)
    scratch = torch.empty(slots * per, dtype=src.dtype, device=src.device)
    dst = torch.empty_like(src)
    fn = _lib.func(f"roms_fast_loop_blocked_{sfx}",
                   [P, P, P, P, L, P] + [I] * 9 + [P, I, P])
    s0 = 0
    for ks in chunk_schedule(nfast):
        hj, hi = halo(ks, Li)
        rc = fn(statp, _lib.ptr(src), _lib.ptr(dst), _lib.ptr(scratch), per,
                _lib.ptr(table), s0, ks, Mj, Li, TJ, TI, hj, hi, slots,
                consts, flags, P(stream))
        _lib.launches["fast_loop_blocked"] += 1
        _lib.check(rc, "fast_loop_blocked")
        src, dst = dst, src
        s0 += ks
    return _carry(list(src), ru0_prev, rv0_prev)
