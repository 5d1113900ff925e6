"""Fast barotropic engine: LF-AM3 predictor/corrector with fast-time
averaging (port of roms_tpu/core/step2d.py; step2d_LF_AM3.h:163-3058
and the fast-loop orchestration of main3d.F:810-918).

Switched as roms_tpu/core/step2d.py:592-616 switches them: on the
EW-periodic channel class (ops/step2d.py `covers`) all substeps run in a
fast-loop kernel, elsewhere, as on the closed DOUBLE_GYRE basin, as a
Python loop of plain tensor code, which is also the kernels' plain
version.  The channel has two kernel engines, chosen by the caller
(`engine`, Model's `fast_loop`): "resident" (kernel 11, roms_tpu's
default) and "blocked" (kernel 12, the j-blocked engine roms_tpu runs
under ROMS_TPU_PALLAS_STEP2D=1 with ROMS_TPU_FASTLOOP_RES=0).  Either
way `aux_pass` finishes the fast-time averages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st
from . import boundary


class FastAverages(NamedTuple):
    """Fast-time averaged coupling fields (mod_coupling.F)."""
    Zt_avg1: torch.Tensor
    DU_avg1: torch.Tensor
    DV_avg1: torch.Tensor
    DU_avg2: torch.Tensor
    DV_avg2: torch.Tensor


class FastCarry(NamedTuple):
    zeta: torch.Tensor        # fast time m
    zeta_prev: torch.Tensor   # fast time m-1
    ubar: torch.Tensor
    ubar_prev: torch.Tensor
    vbar: torch.Tensor
    vbar_prev: torch.Tensor
    rzeta_prev: torch.Tensor  # predictor rhs history (fast step m-1)
    rubar_prev: torch.Tensor
    rvbar_prev: torch.Tensor
    rufrc: torch.Tensor       # converted 2D<-3D coupling forcing
    rvfrc: torch.Tensor
    ru0: torch.Tensor
    rv0: torch.Tensor
    avg: FastAverages


def _check_supported(cfg: ModelConfig):
    bc = cfg.bc
    if bc.volcons or cfg.wetdry or cfg.sal_scalar:
        raise NotImplementedError(
            "VolCons and SAL in the fast loop: ROADMAP Queue 1 item 6; "
            "WET_DRY: ROADMAP Queue 1 item 7")
    for lbc in (bc.zeta, bc.ubar, bc.vbar):
        boundary._check(lbc)


def _flux_state(cfg: ModelConfig, grid: Grid, zeta, ubar, vbar):
    """Total depth and integrated mass fluxes (step2d_LF_AM3.h:624-714)."""
    Drhs = zeta + grid.h
    DUon = ubar * st.avg_x(Drhs) * grid.on_u
    DVom = vbar * st.avg_y(Drhs) * grid.om_v
    if cfg.bc.ew_periodic:
        Drhs, DUon, DVom = (st.periodic_x(Drhs), st.periodic_x(DUon),
                            st.periodic_x(DVom))
    if cfg.bc.ns_periodic:
        Drhs, DUon, DVom = (st.periodic_y(Drhs), st.periodic_y(DUon),
                            st.periodic_y(DVom))
    return Drhs, DUon, DVom


def _gzeta(cfg, rhoS, rhoA, zwrk, var_rho: bool):
    """Pressure-gradient free-surface factors (step2d_LF_AM3.h:905-983)."""
    if var_rho:
        fac = 1000.0 / cfg.rho0
        gzeta = (fac + rhoS) * zwrk
        return gzeta, gzeta * zwrk, zwrk * (rhoS - rhoA)
    return zwrk, zwrk * zwrk, None


def _pg2d(cfg: ModelConfig, grid: Grid, gzeta, gzeta2, gzetaSA, zwrk,
          rhoA, var_rho: bool):
    """Barotropic pressure-gradient terms (step2d_LF_AM3.h:1098-1211)."""
    h = grid.h
    cff1 = 0.5 * cfg.g
    third = 1.0 / 3.0
    pg_u = (st.im1(h) + h) * (st.im1(gzeta) - gzeta) + \
        (st.im1(gzeta2) - gzeta2)
    pg_v = (st.jm1(h) + h) * (st.jm1(gzeta) - gzeta) + \
        (st.jm1(gzeta2) - gzeta2)
    if var_rho:
        pg_u = pg_u + (st.im1(h) - h) * (
            st.im1(gzetaSA) + gzetaSA
            + third * (st.im1(rhoA) - rhoA) * (st.im1(zwrk) - zwrk))
        pg_v = pg_v + (st.jm1(h) - h) * (
            st.jm1(gzetaSA) + gzetaSA
            + third * (st.jm1(rhoA) - rhoA) * (st.jm1(zwrk) - zwrk))
    return cff1 * grid.on_u * pg_u, cff1 * grid.om_v * pg_v


def _rhs2d_momentum(cfg: ModelConfig, grid: Grid, ubar, vbar,
                    Drhs, DUon, DVom, gzeta, gzeta2, gzetaSA, zwrk, rhoA,
                    var_rho: bool):
    """2D momentum RHS: pressure gradient, C4 advection (:1268-1392),
    Coriolis (:1425-1444), metric terms, harmonic viscosity
    (:1562-1652)."""
    ewp = cfg.bc.ew_periodic
    nsp = cfg.bc.ns_periodic
    rhs_u, rhs_v = _pg2d(cfg, grid, gzeta, gzeta2, gzetaSA, zwrk,
                         rhoA, var_rho)

    if cfg.uv_adv:
        sixth = 1.0 / 6.0
        gu = st.lap_x(ubar)
        Dgu = st.lap_x(DUon)
        if ewp:
            gu, Dgu = st.periodic_x(gu), st.periodic_x(Dgu)
        else:
            gu = st.clamp_east(st.clamp_west(gu, col=2, at=1),
                               col=-2, at=-1)
            Dgu = st.clamp_east(st.clamp_west(Dgu, col=2, at=1),
                                col=-2, at=-1)
        UFx = 0.25 * (ubar + st.ip1(ubar) - sixth * (gu + st.ip1(gu))) * \
            (DUon + st.ip1(DUon) - sixth * (Dgu + st.ip1(Dgu)))

        gue = st.lap_y(ubar)
        if nsp:
            gue = st.periodic_y(gue)
        else:
            gue = st.clamp_north(st.clamp_south(gue, row=1), row=-2)
        DgDV = st.lap_x(DVom)
        if ewp:
            DgDV = st.periodic_x(DgDV)
        UFe = 0.25 * (ubar + st.jm1(ubar) - sixth * (gue + st.jm1(gue))) * \
            (DVom + st.im1(DVom) - sixth * (DgDV + st.im1(DgDV)))

        gv = st.lap_x(vbar)
        if ewp:
            gv = st.periodic_x(gv)
        else:
            gv = st.clamp_east(st.clamp_west(gv, col=1, at=0),
                               col=-2, at=-1)
        DgDU = st.lap_y(DUon)
        if nsp:
            DgDU = st.periodic_y(DgDU)
        VFx = 0.25 * (vbar + st.im1(vbar) - sixth * (gv + st.im1(gv))) * \
            (DUon + st.jm1(DUon) - sixth * (DgDU + st.jm1(DgDU)))

        gve = st.lap_y(vbar)
        Dgve = st.lap_y(DVom)
        if nsp:
            gve, Dgve = st.periodic_y(gve), st.periodic_y(Dgve)
        else:
            gve = st.clamp_north(st.clamp_south(gve, row=2, at=1),
                                 row=-2)
            Dgve = st.clamp_north(st.clamp_south(Dgve, row=2, at=1),
                                  row=-2)
        VFe = 0.25 * (vbar + st.jp1(vbar) - sixth * (gve + st.jp1(gve))) * \
            (DVom + st.jp1(DVom) - sixth * (Dgve + st.jp1(Dgve)))

        rhs_u = rhs_u - (UFx - st.im1(UFx)) - (st.jp1(UFe) - UFe)
        rhs_v = rhs_v - (st.ip1(VFx) - VFx) - (VFe - st.jm1(VFe))

    def ring(*fs):
        if ewp:
            fs = tuple(st.periodic_x(f) for f in fs)
        if nsp:
            fs = tuple(st.periodic_y(f) for f in fs)
        return fs

    if cfg.uv_cor:
        cffc = 0.5 * Drhs * grid.fomn
        UFxc, VFec = ring(cffc * (vbar + st.jp1(vbar)),
                          cffc * (ubar + st.ip1(ubar)))
        rhs_u = rhs_u + 0.5 * (UFxc + st.im1(UFxc))
        rhs_v = rhs_v - 0.5 * (VFec + st.jm1(VFec))

    if cfg.curvgrid and cfg.uv_adv:
        cff1_ = 0.5 * (vbar + st.jp1(vbar))
        cff2_ = 0.5 * (ubar + st.ip1(ubar))
        cffm = Drhs * (cff1_ * grid.dndx - cff2_ * grid.dmde)
        UFxm, VFem = ring(cffm * cff1_, cffm * cff2_)
        rhs_u = rhs_u + 0.5 * (UFxm + st.im1(UFxm))
        rhs_v = rhs_v - 0.5 * (VFem + st.jm1(VFem))

    if cfg.mixing.visc2 > 0.0:
        Drhs_p = 0.25 * (Drhs + st.im1(Drhs) + st.jm1(Drhs)
                         + st.im1jm1(Drhs))
        pn, pm = grid.pn, grid.pm
        upn = pn + st.im1(pn)
        vpm = pm + st.jm1(pm)
        cff_r, = ring(grid.visc2_r * Drhs * 0.5 * (
            grid.pmon_r * st.dx_p(upn * ubar)
            - grid.pnom_r * st.dy_p(vpm * vbar)))
        UFxv = grid.on_r * grid.on_r * cff_r
        VFev = grid.om_r * grid.om_r * cff_r
        vpn = pn + st.jm1(pn)
        upm = pm + st.im1(pm)
        cff_p, = ring(grid.visc2_p * Drhs_p * 0.5 * (
            grid.pmon_p * st.dx_m(vpn * vbar)
            + grid.pnom_p * st.dy_m(upm * ubar)) * grid.pmask)
        UFev = grid.om_p * grid.om_p * cff_p
        VFxv = grid.on_p * grid.on_p * cff_p
        rhs_u = rhs_u + 0.5 * upn * st.dx_m(UFxv) \
            + 0.5 * upm * (st.jp1(UFev) - UFev)
        rhs_v = rhs_v + 0.5 * vpn * (st.ip1(VFxv) - VFxv) \
            - 0.5 * vpm * st.dy_m(VFev)
    return rhs_u, rhs_v


def _uv_bc(cfg, u, v):
    return (boundary.bc_u(u, cfg.bc.ubar, cfg.gamma2),
            boundary.bc_v(v, cfg.bc.vbar, cfg.gamma2))


def ab3_coefs(iic: int):
    """(a1, a2, a3) of the 2D<-3D forcing extrapolation, AB3 in the
    baroclinic step count (step2d_LF_AM3.h:2190-2425)."""
    a1 = 1.0 if iic == 0 else (1.5 if iic == 1 else 23.0 / 12.0)
    a2 = 0.0 if iic == 0 else (0.5 if iic == 1 else 16.0 / 12.0)
    a3 = 0.0 if iic <= 1 else 5.0 / 12.0
    return a1, a2, a3


def make_substeps(cfg: ModelConfig, nfast: int, w1, w2,
                  var_rho: bool = True):
    """The plain substep loop: returns
    substeps(grid, zeta0, ubar0, vbar0, rufrc, rvfrc, rhoS, rhoA,
             ru0_prev, rv0_prev, ru0_prev2, rv0_prev2, iic) -> FastCarry
    after nfast predictor + corrector substeps."""
    _check_supported(cfg)
    dtfast = cfg.dt / cfg.ndtfast
    w1 = [float(x) for x in w1]
    w2 = [float(x) for x in w2]

    def predictor(grid, iif, c: FastCarry, rhoS, rhoA, iic,
                  ru0_prev2, rv0_prev2):
        pmn = grid.pm * grid.pn
        pmn4_u = (grid.pm + st.im1(grid.pm)) * (grid.pn + st.im1(grid.pn))
        pmn4_v = (grid.pm + st.jm1(grid.pm)) * (grid.pn + st.jm1(grid.pn))
        first = iif == 1
        Drhs, DUon, DVom = _flux_state(cfg, grid, c.zeta, c.ubar, c.vbar)

        # fast-time averaging, predictor branch (:742-800)
        avg = c.avg
        if first:
            cffA2 = (-1.0 / 12.0) * w2[iif]
            avg = FastAverages(0.0 * c.zeta, 0.0 * DUon, 0.0 * DVom,
                               cffA2 * DUon, cffA2 * DVom)
        else:
            cffA1 = w1[iif - 2]
            cffA2 = (8.0 / 12.0) * w2[iif - 1] - (1.0 / 12.0) * w2[iif]
            avg = FastAverages(avg.Zt_avg1 + cffA1 * c.zeta,
                               avg.DU_avg1 + cffA1 * DUon,
                               avg.DV_avg1 + cffA1 * DVom,
                               avg.DU_avg2 + cffA2 * DUon,
                               avg.DV_avg2 + cffA2 * DVom)

        # free surface: forward Euler first step, leapfrog after
        rhs_zeta = (DUon - st.ip1(DUon)) + (DVom - st.jp1(DVom))
        if first:
            zeta_new = c.zeta + pmn * dtfast * rhs_zeta
            zwrk = 0.5 * (c.zeta + zeta_new)
        else:
            zeta_new = c.zeta_prev + pmn * (2.0 * dtfast) * rhs_zeta
            cff4 = 4.0 / 25.0
            cff5 = 1.0 - 2.0 * cff4
            zwrk = cff5 * c.zeta + cff4 * (c.zeta_prev + zeta_new)
        zeta_new = zeta_new * grid.rmask
        gz, gz2, gzSA = _gzeta(cfg, rhoS, rhoA, zwrk, var_rho)
        zeta_new = boundary.bc_rho(zeta_new, cfg.bc.zeta)
        Dnew = zeta_new + grid.h

        rhs_u, rhs_v = _rhs2d_momentum(cfg, grid, c.ubar, c.vbar, Drhs,
                                       DUon, DVom, gz, gz2, gzSA, zwrk,
                                       rhoA, var_rho)

        # 2D/3D coupling on the first fast step (:2190-2425), AB3 in
        # the baroclinic step count
        if first:
            rufrc_c = c.rufrc - rhs_u
            rvfrc_c = c.rvfrc - rhs_v
            a1, a2, a3 = ab3_coefs(iic)
            rhs_u = rhs_u + (a1 * rufrc_c - a2 * c.ru0 + a3 * ru0_prev2)
            rhs_v = rhs_v + (a1 * rvfrc_c - a2 * c.rv0 + a3 * rv0_prev2)
            Dstp, cffdt = c.zeta + grid.h, 0.5 * dtfast
            ub_base, vb_base = c.ubar, c.vbar
        else:
            rufrc_c, rvfrc_c = c.rufrc, c.rvfrc
            rhs_u = rhs_u + rufrc_c
            rhs_v = rhs_v + rvfrc_c
            Dstp, cffdt = c.zeta_prev + grid.h, dtfast
            ub_base, vb_base = c.ubar_prev, c.vbar_prev

        Du_stp = Dstp + st.im1(Dstp)
        Dv_stp = Dstp + st.jm1(Dstp)
        Du_new = Dnew + st.im1(Dnew)
        Dv_new = Dnew + st.jm1(Dnew)
        ubar_new = (ub_base * Du_stp + pmn4_u * cffdt * rhs_u) / Du_new
        vbar_new = (vb_base * Dv_stp + pmn4_v * cffdt * rhs_v) / Dv_new
        ubar_new, vbar_new = _uv_bc(cfg, ubar_new * grid.umask,
                                    vbar_new * grid.vmask)
        return (zeta_new, ubar_new, vbar_new, rhs_zeta, rhs_u, rhs_v,
                rufrc_c, rvfrc_c, avg)

    def corrector(grid, iif, c: FastCarry, zeta_p, ubar_p, vbar_p,
                  rz_m, ru_m, rv_m, rufrc_c, rvfrc_c, rhoS, rhoA):
        pmn = grid.pm * grid.pn
        pmn4_u = (grid.pm + st.im1(grid.pm)) * (grid.pn + st.im1(grid.pn))
        pmn4_v = (grid.pm + st.jm1(grid.pm)) * (grid.pn + st.jm1(grid.pn))
        first = iif == 1
        Drhs, DUon, DVom = _flux_state(cfg, grid, zeta_p, ubar_p, vbar_p)

        # fast-averaging corrector branch (:795-806)
        cffA2 = w2[iif - 1] if first else (5.0 / 12.0) * w2[iif - 1]
        avg = c.avg._replace(DU_avg2=c.avg.DU_avg2 + cffA2 * DUon,
                             DV_avg2=c.avg.DV_avg2 + cffA2 * DVom)

        # free surface: backward Euler first step / AM3 after (:903-983)
        div = (DUon - st.ip1(DUon)) + (DVom - st.jp1(DVom))
        if first:
            zeta_new = c.zeta + pmn * dtfast * div
            zwrk = 0.5 * (c.zeta + zeta_new)
        else:
            zeta_new = c.zeta + pmn * ((5.0 / 12.0) * dtfast * div
                                       + (8.0 / 12.0) * dtfast * rz_m
                                       - (1.0 / 12.0) * dtfast
                                       * c.rzeta_prev)
            cff4 = 2.0 / 5.0
            zwrk = (1.0 - cff4) * zeta_new + cff4 * zeta_p
        zeta_new = zeta_new * grid.rmask
        gz, gz2, gzSA = _gzeta(cfg, rhoS, rhoA, zwrk, var_rho)
        zeta_new = boundary.bc_rho(zeta_new, cfg.bc.zeta)
        Dnew = zeta_new + grid.h

        rhs_u, rhs_v = _rhs2d_momentum(cfg, grid, ubar_p, vbar_p, Drhs,
                                       DUon, DVom, gz, gz2, gzSA, zwrk,
                                       rhoA, var_rho)
        rhs_u = rhs_u + rufrc_c
        rhs_v = rhs_v + rvfrc_c

        # momentum corrector: backward Euler first / AM3 after
        Dstp = c.zeta + grid.h
        Du_stp = Dstp + st.im1(Dstp)
        Dv_stp = Dstp + st.jm1(Dstp)
        Du_new = Dnew + st.im1(Dnew)
        Dv_new = Dnew + st.jm1(Dnew)
        half = 0.5 * dtfast
        if first:
            rhs_u_t = half * rhs_u
            rhs_v_t = half * rhs_v
        else:
            rhs_u_t = half * ((5.0 / 12.0) * rhs_u + (8.0 / 12.0) * ru_m
                              - (1.0 / 12.0) * c.rubar_prev)
            rhs_v_t = half * ((5.0 / 12.0) * rhs_v + (8.0 / 12.0) * rv_m
                              - (1.0 / 12.0) * c.rvbar_prev)
        ubar_new = (c.ubar * Du_stp + pmn4_u * rhs_u_t) / Du_new
        vbar_new = (c.vbar * Dv_stp + pmn4_v * rhs_v_t) / Dv_new
        ubar_new, vbar_new = _uv_bc(cfg, ubar_new * grid.umask,
                                    vbar_new * grid.vmask)
        return FastCarry(
            zeta=zeta_new, zeta_prev=c.zeta,
            ubar=ubar_new, ubar_prev=c.ubar,
            vbar=vbar_new, vbar_prev=c.vbar,
            rzeta_prev=rz_m, rubar_prev=ru_m, rvbar_prev=rv_m,
            rufrc=rufrc_c, rvfrc=rvfrc_c,
            ru0=c.ru0, rv0=c.rv0, avg=avg)

    def substeps(grid, zeta0, ubar0, vbar0, rufrc, rvfrc, rhoS, rhoA,
                 ru0_prev, rv0_prev, ru0_prev2, rv0_prev2, iic: int):
        zeros = torch.zeros_like(zeta0)
        c = FastCarry(
            zeta=zeta0, zeta_prev=zeta0,
            ubar=ubar0, ubar_prev=ubar0,
            vbar=vbar0, vbar_prev=vbar0,
            rzeta_prev=zeros, rubar_prev=zeros, rvbar_prev=zeros,
            rufrc=rufrc, rvfrc=rvfrc,
            ru0=ru0_prev, rv0=rv0_prev,
            avg=FastAverages(zeros, zeros, zeros, zeros, zeros))
        for iif in range(1, nfast + 1):
            (zeta_p, ubar_p, vbar_p, rz_m, ru_m, rv_m, rufrc_c, rvfrc_c,
             avg) = predictor(grid, iif, c, rhoS, rhoA, iic, ru0_prev2,
                              rv0_prev2)
            c = corrector(grid, iif, c._replace(avg=avg), zeta_p, ubar_p,
                          vbar_p, rz_m, ru_m, rv_m, rufrc_c, rvfrc_c,
                          rhoS, rhoA)
        return c

    return substeps


ENGINES = ("resident", "blocked")


def fast_loop_kernel(cfg: ModelConfig, engine: str = "resident",
                     use_kernels: bool = True):
    """The kernel wrapper the fast loop runs (ops/step2d.py
    `fast_loop_res` or `fast_loop_blocked`), or None for the plain loop:
    the engine's kernel inside the channel class, the plain loop outside
    it whichever the engine, as roms_tpu takes jnp there."""
    from ..ops import step2d as op
    if engine not in ENGINES:
        raise ValueError(f"fast loop engine {engine!r}: one of {ENGINES}")
    if not (use_kernels and op.covers(cfg)):
        return None
    return op.fast_loop_res if engine == "resident" else op.fast_loop_blocked


def make_fast_loop(cfg: ModelConfig, nfast: int, w1, w2,
                   var_rho: bool = True, use_kernels: bool = True,
                   engine: str = "resident"):
    """Build the fast barotropic loop.

    nfast, w1, w2: from core.weights.power_law_weights (0-based numpy;
    weight(1,i) of the reference is w1[i-1]); engine: "resident" or
    "blocked" (`fast_loop_kernel`).  Returns
    fast_loop(grid, zeta0, ubar0, vbar0, rufrc, rvfrc, rhoS, rhoA,
              ru0_prev, rv0_prev, ru0_prev2, rv0_prev2, iic)
      -> (FastAverages, rufrc_eff, rvfrc_eff, zeta, ubar, vbar)
    """
    kernel = fast_loop_kernel(cfg, engine, use_kernels)
    substeps = make_substeps(cfg, nfast, w1, w2, var_rho)
    w1 = [float(x) for x in w1]
    w2 = [float(x) for x in w2]

    def aux_pass(grid, c: FastCarry):
        # auxiliary (nfast+1) predictor pass: final accumulation only
        # (step2d_LF_AM3.h:821-860); averages get only ring refreshes
        _, DUon, DVom = _flux_state(cfg, grid, c.zeta, c.ubar, c.vbar)
        cffA1 = w1[nfast - 1]
        cffA2 = (8.0 / 12.0) * w2[nfast] - (1.0 / 12.0) * w2[nfast + 1]

        def ring(f):
            if cfg.bc.ew_periodic:
                f = st.periodic_x(f)
            if cfg.bc.ns_periodic:
                f = st.periodic_y(f)
            return f

        a = c.avg
        avg = FastAverages(
            Zt_avg1=ring(a.Zt_avg1 + cffA1 * c.zeta),
            DU_avg1=ring(a.DU_avg1 + cffA1 * DUon),
            DV_avg1=ring(a.DV_avg1 + cffA1 * DVom),
            DU_avg2=ring(a.DU_avg2 + cffA2 * DUon),
            DV_avg2=ring(a.DV_avg2 + cffA2 * DVom))
        return avg, c.rufrc, c.rvfrc, c.zeta, c.ubar, c.vbar

    def fast_loop(grid, zeta0, ubar0, vbar0, rufrc, rvfrc, rhoS, rhoA,
                  ru0_prev, rv0_prev, ru0_prev2, rv0_prev2, iic: int):
        args = (zeta0, ubar0, vbar0, rufrc, rvfrc, rhoS, rhoA, ru0_prev,
                rv0_prev, ru0_prev2, rv0_prev2, iic)
        if kernel is not None:
            c = kernel(cfg, grid, nfast, w1, w2, var_rho, *args)
        else:
            c = substeps(grid, *args)
        return aux_pass(grid, c)

    return fast_loop
