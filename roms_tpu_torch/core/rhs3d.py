"""3D momentum right-hand side (port of roms_tpu/core/rhs3d.py;
rhs3d.F:495-1830): Coriolis, curvilinear metric terms, UP3 horizontal
and C4_SW vertical advection, plus the vertical integral that forces
the barotropic mode.

ru/rv arrive initialized by the pressure gradient; every term adds.
The fused sum is kernel 3 (ops/rhs3d.py); these term functions are
its plain version.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st

GADV = -0.25     # upstream-bias hyperdiffusion weight (rhs3d.F:329)


def _ring_x(cfg, *fs):
    if cfg.bc.ew_periodic:
        return tuple(st.periodic_x(f) for f in fs)
    return fs


def _ring_y(cfg, *fs):
    if cfg.bc.ns_periodic:
        return tuple(st.periodic_y(f) for f in fs)
    return fs


def coriolis(cfg: ModelConfig, grid: Grid, u, v, Hz):
    """Energy-conserving Coriolis with Hz weighting (rhs3d.F:502-527)."""
    cff = 0.5 * Hz * grid.fomn
    UFx = cff * (v + st.jp1(v))
    VFe = cff * (u + st.ip1(u))
    UFx, VFe = _ring_x(cfg, UFx, VFe)
    UFx, VFe = _ring_y(cfg, UFx, VFe)
    return 0.5 * (UFx + st.im1(UFx)), -0.5 * (VFe + st.jm1(VFe))


def curv_metric(cfg: ModelConfig, grid: Grid, u, v, Hz):
    """Curvilinear transformation terms (rhs3d.F:577-660)."""
    cff1 = 0.5 * (v + st.jp1(v))
    cff2 = 0.5 * (u + st.ip1(u))
    cff = Hz * (cff1 * grid.dndx - cff2 * grid.dmde)
    UFx = cff * cff1
    VFe = cff * cff2
    UFx, VFe = _ring_x(cfg, UFx, VFe)
    UFx, VFe = _ring_y(cfg, UFx, VFe)
    return 0.5 * (UFx + st.im1(UFx)), -0.5 * (VFe + st.jm1(VFe))


def _up3_upwind(cff1, curv_m, curv_p, flux2, hyper):
    """0.25*(cff1 + Gadv*curv_up)*(flux2 + Gadv*0.5*hyper)."""
    curv = torch.where(cff1 > 0.0, curv_m, curv_p)
    return 0.25 * (cff1 + GADV * curv) * (flux2 + GADV * 0.5 * hyper)


def hadv_uv(cfg: ModelConfig, grid: Grid, u, v, Huon, Hvom):
    """UP3 horizontal momentum advection (rhs3d.F:668-1010); returns
    the -div(flux) contributions."""
    if cfg.uv_hadv != "up3":
        raise NotImplementedError(
            f"momentum advection '{cfg.uv_hadv}': ROADMAP Queue 1 "
            "item 7")
    ewp = cfg.bc.ew_periodic
    nsp = cfg.bc.ns_periodic
    uxx = st.lap_x(u)
    Huxx = st.lap_x(Huon)
    if ewp:
        uxx, Huxx = st.periodic_x(uxx), st.periodic_x(Huxx)
    else:
        # uxx(Istr)=uxx(Istr+1); uxx(Iend+1)=uxx(Iend) (rhs3d.F:732-746)
        uxx = st.clamp_east(st.clamp_west(uxx, col=2, at=1),
                            col=-2, at=-1)
        Huxx = st.clamp_east(st.clamp_west(Huxx, col=2, at=1),
                             col=-2, at=-1)
    UFx = _up3_upwind(u + st.ip1(u), uxx, st.ip1(uxx),
                      Huon + st.ip1(Huon), Huxx + st.ip1(Huxx))
    UFx, = _ring_x(cfg, UFx)

    uee = st.lap_y(u)
    if nsp:
        uee = st.periodic_y(uee)
    else:
        uee = st.clamp_north(st.clamp_south(uee, row=1), row=-2)
    Hvxx, = _ring_x(cfg, st.lap_x(Hvom))
    cff2 = Hvom + st.im1(Hvom)
    curv = torch.where(cff2 > 0.0, st.jm1(uee), uee)
    UFe = 0.25 * (u + st.jm1(u) + GADV * curv) * \
        (cff2 + GADV * 0.5 * (Hvxx + st.im1(Hvxx)))

    vxx = st.lap_x(v)
    if ewp:
        vxx = st.periodic_x(vxx)
    else:
        vxx = st.clamp_east(st.clamp_west(vxx, col=1, at=0),
                            col=-2, at=-1)
    Huee, = _ring_y(cfg, st.lap_y(Huon))
    cff2 = Huon + st.jm1(Huon)
    curv = torch.where(cff2 > 0.0, st.im1(vxx), vxx)
    VFx = 0.25 * (v + st.im1(v) + GADV * curv) * \
        (cff2 + GADV * 0.5 * (Huee + st.jm1(Huee)))

    vee = st.lap_y(v)
    Hvee = st.lap_y(Hvom)
    if nsp:
        vee, Hvee = st.periodic_y(vee), st.periodic_y(Hvee)
    else:
        vee = st.clamp_north(st.clamp_south(vee, row=2, at=1), row=-2)
        Hvee = st.clamp_north(st.clamp_south(Hvee, row=2, at=1), row=-2)
    VFe = _up3_upwind(v + st.jp1(v), vee, st.jp1(vee),
                      Hvom + st.jp1(Hvom), Hvee + st.jp1(Hvee))
    VFe, = _ring_y(cfg, VFe)

    ru = -(UFx - st.im1(UFx)) - (st.jp1(UFe) - UFe)
    rv = -(st.ip1(VFx) - VFx) - (VFe - st.jm1(VFe))
    return ru, rv


def vadv_uv(cfg: ModelConfig, u, v, W):
    """C4_SW vertical momentum advection with 4th-order W averaging
    (rhs3d.F:1133-1168); returns the -dFC/dk contributions."""
    if cfg.uv_vadv != "c4_sw":
        raise NotImplementedError(
            f"vertical momentum advection '{cfg.uv_vadv}': ROADMAP "
            "Queue 1 item 7")
    c1, c2 = 9.0 / 16.0, 1.0 / 16.0
    N = u.shape[0]
    if cfg.bc.ew_periodic:
        W = st.periodic_x(W)
    if cfg.bc.ns_periodic:
        W = st.periodic_y(W)
    # the reach-2 arm re-wraps the intermediate shift on a periodic axis
    Wm = st.im1(W)
    if cfg.bc.ew_periodic:
        Wm = st.periodic_x(Wm)
    Wjm = st.jm1(W)
    if cfg.bc.ns_periodic:
        Wjm = st.periodic_y(Wjm)
    Wu = c1 * (W + Wm) - c2 * (st.ip1(W) + st.im1(Wm))
    Wv = c1 * (W + Wjm) - c2 * (st.jp1(W) + st.jm1(Wjm))

    def flux(q, Wq):
        Fi = (c1 * (q[1:-2] + q[2:-1]) - c2 * (q[:-3] + q[3:])) * Wq[2:-2]
        F1 = (c1 * (q[0] + q[1]) - c2 * (q[0] + q[2])) * Wq[1]
        Fn = (c1 * (q[-2] + q[-1]) - c2 * (q[-3] + q[-1])) * Wq[N - 1]
        zeros = torch.zeros_like(q[:1])
        return torch.cat([zeros, F1[None], Fi, Fn[None], zeros], dim=0)

    FCu = flux(u, Wu)
    FCv = flux(v, Wv)
    return -(FCu[1:] - FCu[:-1]), -(FCv[1:] - FCv[:-1])


def rhs3d_terms(cfg: ModelConfig, grid: Grid, u, v, Hz, Huon, Hvom, W,
                ru, rv):
    """Coriolis + metric + advection added to (ru, rv), term by term in
    rhs3d_tile's order (the roms_tpu jnp path)."""
    if cfg.uv_cor:
        dru, drv = coriolis(cfg, grid, u, v, Hz)
        ru, rv = ru + dru, rv + drv
    if cfg.curvgrid and cfg.uv_adv:
        dru, drv = curv_metric(cfg, grid, u, v, Hz)
        ru, rv = ru + dru, rv + drv
    if cfg.uv_adv:
        dru, drv = hadv_uv(cfg, grid, u, v, Huon, Hvom)
        ru, rv = ru + dru, rv + drv
        dru, drv = vadv_uv(cfg, u, v, W)
        ru, rv = ru + dru, rv + drv
    return ru, rv


def rhs3d_momentum(cfg: ModelConfig, grid: Grid, u, v, Hz, Huon, Hvom,
                   W, ru, rv, use_kernels: bool = True):
    """Fused RHS (kernel 3, ops/rhs3d.py) in its class, whose output ring
    rows j = 0 and Mj-1 are zero, dead data that bc_u/bc_v overwrite;
    outside it (NS-periodic grids, where those rows are live) the terms
    above with roms_tpu's rows."""
    from ..ops import rhs3d as op
    if not op.covers(cfg):
        return rhs3d_terms(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv)
    fn = op.rhs3d_momentum if use_kernels else op.rhs3d_momentum_plain
    return fn(cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv)


def integrate_rufrc(cfg: ModelConfig, grid: Grid, ru, rv, forcing,
                    bustr, bvstr):
    """Vertical integral of the 3D RHS + stress difference -> 2D
    forcing (rhs3d.F:1697-1830)."""
    rufrc = torch.sum(ru, dim=0) + \
        (forcing.sustr - bustr) * grid.om_u * grid.on_u
    rvfrc = torch.sum(rv, dim=0) + \
        (forcing.svstr - bvstr) * grid.om_v * grid.on_v
    return rufrc, rvfrc
