"""Kernel 9: the fast barotropic loop (csrc/step2d.cu), all nfast
predictor + corrector substeps in one call.

Replaces roms_tpu/ops/pallas_step2d.py `fast_loop_pallas_res`; the
plain version is core/step2d.py's substep loop.  Both return the 16
carry fields (FastCarry); core/step2d.py's `aux_pass` finishes the
averages either way.  `covers` is `_class_ok` (pallas_step2d.py:890):
an EW-periodic channel with closed N/S walls for zeta, ubar and vbar,
no VolCons, no wet/dry.  The wrapper uploads the per-substep scalar
table once; the CUDA side then launches PHASES kernels per substep with
no host synchronisation in between.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import CLOSED, PERIODIC
from . import _lib

# (Mj, Li) grid fields the kernel reads, then rhoS, rhoA and the AB3
# histories ru0, rv0, ru0p2, rv0p2 (csrc/step2d.cu enum Stat)
STATICS = ("h", "pm", "pn", "rmask", "umask", "vmask", "fomn", "dndx",
           "dmde", "on_u", "om_v", "pmon_r", "pnom_r", "pmon_p", "pnom_p",
           "on_r", "om_r", "on_p", "om_p", "pmask", "visc2_r", "visc2_p")
NPLANE = 27      # 16 carry planes + 11 scratch planes (enum Plane)
PHASES = 6       # CUDA launches per substep


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


def fast_loop_res(cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0, vbar0,
                  rufrc, rvfrc, rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2,
                  rv0_prev2, iic):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    args = (cfg, grid, nfast, w1, w2, var_rho, zeta0, ubar0, vbar0, rufrc,
            rvfrc, rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2, rv0_prev2,
            iic)
    if zeta0.device.type == "cpu":
        return fast_loop_res_plain(*args)
    if not covers(cfg):
        raise NotImplementedError(
            "fast loop kernel covers the EW-periodic channel with closed "
            "N/S walls, without VolCons or wet/dry")
    from ..core.step2d import FastAverages, FastCarry
    stat, sfx, stream = _lib.prepare(
        "fast_loop_res", [getattr(grid, n) for n in STATICS]
        + [rhoS, rhoA, ru0_prev, rv0_prev, ru0_prev2, rv0_prev2])
    init, _, _ = _lib.prepare("fast_loop_res",
                              [zeta0, ubar0, vbar0, rufrc, rvfrc])
    Mj, Li = zeta0.shape
    if any(x.shape != (Mj, Li) for x in stat + init) or Li < 4 or Mj < 4:
        raise ValueError("fast_loop_res: inconsistent shapes")
    buf = torch.empty((NPLANE, Mj, Li), dtype=zeta0.dtype,
                      device=zeta0.device)
    zeta0, ubar0, vbar0, rufrc, rvfrc = init
    for k, x in enumerate((zeta0, zeta0, ubar0, ubar0, vbar0, vbar0)):
        buf[k].copy_(x)
    buf[6:9].zero_()
    buf[9].copy_(rufrc)
    buf[10].copy_(rvfrc)
    buf[11:16].zero_()
    table = torch.tensor(scalar_table(nfast, w1, w2, iic),
                         dtype=zeta0.dtype, device=zeta0.device)
    final = (ctypes.c_int * 16)()
    consts = (ctypes.c_double * 4)(cfg.g, cfg.rho0, cfg.dt / cfg.ndtfast,
                                   cfg.gamma2)
    flags = (int(bool(var_rho)) | int(bool(cfg.uv_adv)) << 1
             | int(bool(cfg.uv_cor)) << 2
             | int(bool(cfg.curvgrid and cfg.uv_adv)) << 3
             | int(cfg.mixing.visc2 > 0.0) << 4)
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_fast_loop_{sfx}", [P, P, P, P, I, I, I, P, I, P])
    rc = fn((P * len(stat))(*[x.data_ptr() for x in stat]),
            _lib.ptr(buf), _lib.ptr(table), final, nfast, Mj, Li, consts,
            flags, P(stream))
    _lib.launches["fast_loop_res"] += 1
    _lib.check(rc, "fast_loop_res")
    f = [buf[final[k]] for k in range(16)]
    return FastCarry(
        zeta=f[0], zeta_prev=f[1], ubar=f[2], ubar_prev=f[3], vbar=f[4],
        vbar_prev=f[5], rzeta_prev=f[6], rubar_prev=f[7], rvbar_prev=f[8],
        rufrc=f[9], rvfrc=f[10], ru0=ru0_prev, rv0=rv0_prev,
        avg=FastAverages(*f[11:16]))
