"""Kernel 4: the 3D momentum corrector (csrc/uv.cu), two entry points.

Replaces roms_tpu/ops/pallas_uv.py `uv_solve_pallas` and
`uv_finish_pallas`.  Every point, ring rows included, matches the
reference: the kernel takes the i-1 and j-1 neighbours of the face
averages with the same wrap as `st.im1`/`st.jm1` (jnp.roll), and on an
EW-periodic grid uv_finish refreshes the Huon/Hvom lanes itself.
`covers` is the class of `use_pallas_uv` (pallas_uv.py:255).

Both are one thread per column and component, streaming the column's
levels once, the state of their later passes in shared memory sized by N
(`solve_launch_shape`, `finish_launch_shape`).
"""

from __future__ import annotations

import torch

from . import _lib, stencil as st
from .tridiag import spline_flux_solve


# uv_solve's threads a block by element size: the sweep keeps 4 N - 2
# values a thread in shared memory (csrc/uv.cu uv_solve_kernel); float32's
# 96 is the fastest of the block sizes `chip_smoke.py --profile` times on
# the H100 at BENCHMARK3's N = 30 (PERF.md)
SOLVE_THREADS = {4: 96, 8: 64}


def solve_launch_shape(N: int, Mj: int, Li: int, itemsize: int):
    """uv_solve's (threads, blocks, dynamic shared memory bytes): two
    blocks (u and v) per range of `threads` columns."""
    B = SOLVE_THREADS[itemsize]
    return B, 2 * -(-(Mj * Li) // B), itemsize * (4 * N - 2) * B


# uv_finish's threads a block by element size: it keeps hz*scale and q,
# 2 N values a thread, in shared memory (csrc/uv.cu uv_finish_kernel);
# float32's 128 ties 64 as the fastest of the block sizes `chip_smoke.py
# --profile` times on the H100 at both full-width shapes (PERF.md)
FINISH_THREADS = {4: 128, 8: 64}


def finish_launch_shape(N: int, Mj: int, Li: int, itemsize: int):
    """uv_finish's (threads, blocks, dynamic shared memory bytes): two
    blocks (u and v) per range of `threads` columns."""
    B = FINISH_THREADS[itemsize]
    return B, 2 * -(-(Mj * Li) // B), itemsize * 2 * N * B


def covers(cfg) -> bool:
    """Spline viscosity on non-NS-periodic grids, no OMEGA_IMPLICIT."""
    return (not cfg.bc.ns_periodic and cfg.mixing.splines_vvisc
            and not cfg.omega_implicit)


def _require(cfg, name):
    if not covers(cfg):
        raise NotImplementedError(
            f"{name} kernel covers spline viscosity on non-NS-periodic "
            "grids without OMEGA_IMPLICIT")


def _correct(q, Hzq, scale, avg1, mask):
    """q <- (q - err)*mask with err from the thickness-weighted mean
    against the fast-time average (step3d_uv.F:595-700)."""
    D = torch.sum(Hzq, dim=0)
    err = (torch.sum(q * Hzq, dim=0) * scale - avg1) / (D * scale)
    return (q - err[None]) * mask[None]


def uv_solve_plain(cfg, grid, u_part, v_part, ru, rv, Hz, Akv, cffab,
                   DU_avg1, DV_avg1):
    """Pre-BC (un, vn): AB3 seed + spline viscosity + first
    barotropic-mean replacement."""
    dt = cfg.dt
    pm, pn = grid.pm, grid.pn
    DC0u = cffab * (pm + st.im1(pm)) * (pn + st.im1(pn))
    DC0v = cffab * (pm + st.jm1(pm)) * (pn + st.jm1(pn))
    Hz_u = 0.5 * (Hz + st.im1(Hz))
    Hz_v = 0.5 * (Hz + st.jm1(Hz))
    AKu = 0.5 * (Akv + st.im1(Akv))
    AKv = 0.5 * (Akv + st.jm1(Akv))
    un = (u_part + DC0u * ru) / Hz_u
    vn = (v_part + DC0v * rv) / Hz_v
    un = un + spline_flux_solve(Hz_u, AKu, un, dt)
    vn = vn + spline_flux_solve(Hz_v, AKv, vn, dt)
    return (_correct(un, Hz_u, grid.on_u, DU_avg1, grid.umask),
            _correct(vn, Hz_v, grid.om_v, DV_avg1, grid.vmask))


def uv_finish_plain(cfg, grid, un, vn, Hz, Huon_old, Hvom_old,
                    DU_avg1, DV_avg1, DU_avg2, DV_avg2):
    """Post-BC (un, vn, ubar, vbar, Huon, Hvom)."""
    Hz_u = 0.5 * (Hz + st.im1(Hz))
    Hz_v = 0.5 * (Hz + st.jm1(Hz))
    on_u, om_v = grid.on_u, grid.om_v
    D_u = torch.sum(Hz_u, dim=0)
    D_v = torch.sum(Hz_v, dim=0)
    un = _correct(un, Hz_u, on_u, DU_avg1, grid.umask)
    vn = _correct(vn, Hz_v, om_v, DV_avg1, grid.vmask)
    ubar = DU_avg1 / (D_u * on_u) * grid.umask
    vbar = DV_avg1 / (D_v * om_v) * grid.vmask
    DCk_u = Hz_u * on_u[None]
    DCk_v = Hz_v * om_v[None]
    Huon = 0.5 * (Huon_old + un * DCk_u)
    Hvom = 0.5 * (Hvom_old + vn * DCk_v)
    errU = (torch.sum(Huon, dim=0) - DU_avg2) / (D_u * on_u)
    errV = (torch.sum(Hvom, dim=0) - DV_avg2) / (D_v * om_v)
    Huon = Huon - DCk_u * errU[None]
    Hvom = Hvom - DCk_v * errV[None]
    if cfg.bc.ew_periodic:
        Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    return un, vn, ubar, vbar, Huon, Hvom


def uv_solve(cfg, grid, u_part, v_part, ru, rv, Hz, Akv, cffab,
             DU_avg1, DV_avg1):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if ru.device.type == "cpu":
        return uv_solve_plain(cfg, grid, u_part, v_part, ru, rv, Hz, Akv,
                              cffab, DU_avg1, DV_avg1)
    return _launch_solve(cfg, grid, u_part, v_part, ru, rv, Hz, Akv, cffab,
                         DU_avg1, DV_avg1)


def _launch_solve(cfg, grid, u_part, v_part, ru, rv, Hz, Akv, cffab,
                  DU_avg1, DV_avg1):
    _require(cfg, "uv_solve")
    tensors, sfx, stream = _lib.prepare(
        "uv_solve", [u_part, v_part, ru, rv, Hz, Akv, grid.pm, grid.pn,
                     grid.umask, grid.vmask, grid.on_u, grid.om_v, DU_avg1,
                     DV_avg1])
    N, Mj, Li = ru.shape
    if N < 2 or Akv.shape != (N + 1, Mj, Li) or any(
            x.shape != ru.shape for x in (u_part, v_part, rv, Hz)):
        raise ValueError("uv_solve: inconsistent shapes")
    threads, _, smem = solve_launch_shape(N, Mj, Li, ru.element_size())
    if smem > _lib.SMEM_PER_BLOCK:
        raise ValueError(f"uv_solve: {N} levels need {smem} B of shared "
                         "memory a block, more than the card's 227 KB")
    out_u = torch.empty_like(ru)
    out_v = torch.empty_like(rv)
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_uv_solve_{sfx}",
                   [P] * 16 + [I] * 3 + [D, D, I, P])
    rc = fn(*[_lib.ptr(x) for x in tensors + [out_u, out_v]],
            N, Mj, Li, float(cfg.dt), float(cffab), threads, P(stream))
    _lib.launches["uv_solve"] += 1
    _lib.check(rc, "uv_solve")
    return out_u, out_v


def uv_finish(cfg, grid, un, vn, Hz, Huon_old, Hvom_old,
              DU_avg1, DV_avg1, DU_avg2, DV_avg2):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if un.device.type == "cpu":
        return uv_finish_plain(cfg, grid, un, vn, Hz, Huon_old, Hvom_old,
                               DU_avg1, DV_avg1, DU_avg2, DV_avg2)
    return _launch_finish(cfg, grid, un, vn, Hz, Huon_old, Hvom_old,
                          DU_avg1, DV_avg1, DU_avg2, DV_avg2)


def _launch_finish(cfg, grid, un, vn, Hz, Huon_old, Hvom_old,
                   DU_avg1, DV_avg1, DU_avg2, DV_avg2):
    _require(cfg, "uv_finish")
    tensors, sfx, stream = _lib.prepare(
        "uv_finish", [un, vn, Hz, Huon_old, Hvom_old, grid.umask,
                      grid.vmask, grid.on_u, grid.om_v, DU_avg1, DV_avg1,
                      DU_avg2, DV_avg2])
    N, Mj, Li = un.shape
    if N < 1 or any(x.shape != un.shape
                    for x in (vn, Hz, Huon_old, Hvom_old)) or \
            (cfg.bc.ew_periodic and Li < 4):
        raise ValueError("uv_finish: inconsistent shapes")
    threads, _, smem = finish_launch_shape(N, Mj, Li, un.element_size())
    if smem > _lib.SMEM_PER_BLOCK:
        raise ValueError(f"uv_finish: {N} levels need {smem} B of shared "
                         "memory a block, more than the card's 227 KB")
    outs = [torch.empty_like(un), torch.empty_like(vn),
            torch.empty_like(DU_avg1), torch.empty_like(DV_avg1),
            torch.empty_like(un), torch.empty_like(vn)]
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_uv_finish_{sfx}", [P] * 19 + [I] * 5 + [P])
    rc = fn(*[_lib.ptr(x) for x in tensors + outs], N, Mj, Li,
            int(cfg.bc.ew_periodic), threads, P(stream))
    _lib.launches["uv_finish"] += 1
    _lib.check(rc, "uv_finish")
    return tuple(outs)
