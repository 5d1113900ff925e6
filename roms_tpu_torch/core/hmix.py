"""Horizontal mixing along s-surfaces (port of the four s-surface
routines of roms_tpu/core/hmix.py: t3dmix2_s.h, t3dmix4_s.h,
uv3dmix2_s.h, uv3dmix4_s.h).

The harmonic forms are forward-Euler corrections of the Hz-weighted
corrector seeds; uv3dmix also feeds the vertically integrated stress
divergence into rufrc/rvfrc.  On the EW-periodic channel uv3dmix2_s
runs as a kernel (kernel 8, ops/uvmix.py), whose plain version is the
function below; the rotated (geo/iso) and Smagorinsky forms come later.
"""

from __future__ import annotations

import torch

from ..config import CLOSED, ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st


def t3dmix2_s(cfg: ModelConfig, grid: Grid, t, t_part, Hz):
    """Add dt * harmonic diffusion of t to t_part (Hz*t units)."""
    if all(d == 0.0 for d in cfg.mixing.tnu2):
        return t_part
    dt = cfg.dt
    pmn = grid.pm * grid.pn
    out = []
    for itrc in range(cfg.NT):
        diff2 = grid.diff2[itrc]
        cffx = 0.25 * (diff2 + st.im1(diff2)) * grid.pmon_u
        cffe = 0.25 * (diff2 + st.jm1(diff2)) * grid.pnom_v
        FX = cffx * (Hz + st.im1(Hz)) * (t[itrc] - st.im1(t[itrc])) \
            * grid.umask
        FE = cffe * (Hz + st.jm1(Hz)) * (t[itrc] - st.jm1(t[itrc])) \
            * grid.vmask
        if cfg.bc.ew_periodic:
            FX = st.periodic_x(FX)
        if cfg.bc.ns_periodic:
            FE = st.periodic_y(FE)
        out.append(t_part[itrc] + dt * pmn * (st.dx_p(FX) + st.dy_p(FE)))
    return torch.stack(out)


def _lap_bc(cfg: ModelConfig, lbc, Lap):
    """Boundary treatment of the intermediate biharmonic Laplacian
    (t3dmix4_s.h:233-290): closed edges zero it, others copy."""
    if cfg.bc.ew_periodic:
        Lap = st.periodic_x(Lap)
    else:
        wv = 0.0 if lbc.west == CLOSED else Lap[..., :, 1]
        ev = 0.0 if lbc.east == CLOSED else Lap[..., :, -2]
        Lap = st.set_col(st.set_col(Lap, 0, wv), -1, ev)
    if cfg.bc.ns_periodic:
        Lap = st.periodic_y(Lap)
    else:
        Lap = st.zero_south(Lap) if lbc.south == CLOSED \
            else st.clamp_south(Lap, row=1)
        Lap = st.zero_north(Lap) if lbc.north == CLOSED \
            else st.clamp_north(Lap, row=-2)
    return Lap


def t3dmix4_s(cfg: ModelConfig, grid: Grid, t, t_part, Hz):
    """Biharmonic tracer mixing along s (t3dmix4_s.h)."""
    if all(d == 0.0 for d in cfg.mixing.tnu4):
        return t_part
    dt = cfg.dt
    pmn = grid.pm * grid.pn
    out = []
    for itrc in range(cfg.NT):
        d4 = grid.diff4[itrc]
        cffx = 0.25 * (d4 + st.im1(d4)) * grid.pmon_u * grid.umask
        cffe = 0.25 * (d4 + st.jm1(d4)) * grid.pnom_v * grid.vmask

        def harm(q):
            FX = cffx * (Hz + st.im1(Hz)) * (q - st.im1(q))
            FE = cffe * (Hz + st.jm1(Hz)) * (q - st.jm1(q))
            if cfg.bc.ew_periodic:
                FX = st.periodic_x(FX)
            if cfg.bc.ns_periodic:
                FE = st.periodic_y(FE)
            return st.dx_p(FX) + st.dy_p(FE)

        Lap = _lap_bc(cfg, cfg.bc.t, pmn * harm(t[itrc]) / Hz)
        out.append(t_part[itrc] - dt * pmn * harm(Lap))
    return torch.stack(out)


def _ring(cfg, *fs):
    if cfg.bc.ew_periodic:
        fs = tuple(st.periodic_x(f) for f in fs)
    if cfg.bc.ns_periodic:
        fs = tuple(st.periodic_y(f) for f in fs)
    return fs


def uv3dmix2_s(cfg: ModelConfig, grid: Grid, u, v, u_part, v_part, Hz,
               rufrc, rvfrc, use_kernels: bool = False):
    """Harmonic viscosity along s (uv3dmix2_s.h:120-222); returns
    (u_part, v_part, rufrc, rvfrc).  With use_kernels, configurations in
    the uvmix kernel's class go through its wrapper (roms_tpu/core/
    hmix.py:58-66)."""
    if cfg.mixing.visc2 <= 0.0:
        return u_part, v_part, rufrc, rvfrc
    if use_kernels:
        from ..ops import uvmix
        if uvmix.covers(cfg):
            return uvmix.uv3dmix2_s(cfg, grid, u, v, u_part, v_part, Hz,
                                    rufrc, rvfrc)
    dt = cfg.dt
    pn, pm = grid.pn, grid.pm
    upn = pn + st.im1(pn)
    upm = pm + st.im1(pm)
    vpn = pn + st.jm1(pn)
    vpm = pm + st.jm1(pm)
    vr, vp = grid.visc2_r, grid.visc2_p
    cff_r = Hz * 0.5 * (grid.pmon_r * st.dx_p(upn * u)
                        - grid.pnom_r * st.dy_p(vpm * v))
    UFx = grid.on_r * grid.on_r * vr * cff_r
    VFe = grid.om_r * grid.om_r * vr * cff_r
    Hz_p = 0.25 * (Hz + st.im1(Hz) + st.jm1(Hz) + st.im1jm1(Hz))
    cff_p = 0.5 * Hz_p * (grid.pmon_p * st.dx_m(vpn * v)
                          + grid.pnom_p * st.dy_m(upm * u)) * grid.pmask
    UFe = grid.om_p * grid.om_p * vp * cff_p
    VFx = grid.on_p * grid.on_p * vp * cff_p
    UFx, VFe, UFe, VFx = _ring(cfg, UFx, VFe, UFe, VFx)
    div_u = 0.5 * upn * st.dx_m(UFx) + 0.5 * upm * (st.jp1(UFe) - UFe)
    div_v = 0.5 * vpn * (st.ip1(VFx) - VFx) - 0.5 * vpm * st.dy_m(VFe)
    u_part = u_part + dt * 0.25 * upm * upn * div_u
    v_part = v_part + dt * 0.25 * vpm * vpn * div_v
    rufrc = rufrc + torch.sum(div_u, dim=0)
    rvfrc = rvfrc + torch.sum(div_v, dim=0)
    return u_part, v_part, rufrc, rvfrc


def uv3dmix4_s(cfg: ModelConfig, grid: Grid, u, v, u_part, v_part, Hz,
               rufrc, rvfrc):
    """Biharmonic viscosity along s (uv3dmix4_s.h): the harmonic stress
    divergence twice, thickness-weighted on the second pass only."""
    if cfg.mixing.visc4 <= 0.0:
        return u_part, v_part, rufrc, rvfrc
    dt = cfg.dt
    pn, pm = grid.pn, grid.pm
    upn = pn + st.im1(pn)
    upm = pm + st.im1(pm)
    vpn = pn + st.jm1(pn)
    vpm = pm + st.jm1(pm)
    Hz_p = 0.25 * (Hz + st.im1(Hz) + st.jm1(Hz) + st.im1jm1(Hz))

    def stress_div(uu, vv, with_hz):
        wr = Hz if with_hz else 1.0
        wp = Hz_p if with_hz else 1.0
        cff_r = wr * 0.5 * (grid.pmon_r * st.dx_p(upn * uu)
                            - grid.pnom_r * st.dy_p(vpm * vv)) \
            * grid.visc4_r
        cff_p = 0.5 * wp * (grid.pmon_p * st.dx_m(vpn * vv)
                            + grid.pnom_p * st.dy_m(upm * uu)) \
            * grid.visc4_p * grid.pmask
        UFx = grid.on_r * grid.on_r * cff_r
        VFe = grid.om_r * grid.om_r * cff_r
        UFe = grid.om_p * grid.om_p * cff_p
        VFx = grid.on_p * grid.on_p * cff_p
        UFx, VFe, UFe, VFx = _ring(cfg, UFx, VFe, UFe, VFx)
        du = 0.5 * upn * st.dx_m(UFx) + 0.5 * upm * (st.jp1(UFe) - UFe)
        dv = 0.5 * vpn * (st.ip1(VFx) - VFx) - 0.5 * vpm * st.dy_m(VFe)
        return du, dv

    LapU, LapV = stress_div(u, v, with_hz=False)
    pmn_u = 0.25 * upm * upn
    pmn_v = 0.25 * vpm * vpn
    LapU = _lap_bc(cfg, cfg.bc.u, LapU * pmn_u)
    LapV = _lap_bc(cfg, cfg.bc.v, LapV * pmn_v)
    du, dv = stress_div(LapU, LapV, with_hz=True)
    u_part = u_part - dt * pmn_u * du
    v_part = v_part - dt * pmn_v * dv
    rufrc = rufrc - torch.sum(du, dim=0)
    rvfrc = rvfrc - torch.sum(dv, dim=0)
    return u_part, v_part, rufrc, rvfrc


def t3dmix2_geo(cfg: ModelConfig, grid: Grid, t, t_part, Hz, z_r,
                use_kernels: bool = False):
    """Harmonic tracer diffusion rotated along geopotential surfaces
    (t3dmix2_geo.h): triad scheme with min/max upwinding of the slope
    terms; the vertical cross-flux FS closes the rotation.  With
    use_kernels, configurations in kernel 16's class go through its
    wrapper (ops/hmix.py) for all tracers at once."""
    if all(d == 0.0 for d in cfg.mixing.tnu2):
        return t_part
    from ..ops import hmix as hmix_op
    fn = hmix_op.rot_div_geo if use_kernels and hmix_op.covers(cfg) \
        else hmix_op.rot_div_geo_plain
    return t_part + cfg.dt * fn(cfg, grid, t, grid.diff2, Hz, z_r)


def _rot_div_geo(cfg: ModelConfig, grid: Grid, q, d2, Hz, z_r, dZdx,
                 dZde):
    """Rotated (geopotential) flux divergence of one tracer field,
    Hz-weighted per unit time (t3dmix2_geo.h:205-290 triad kernel);
    shared by the harmonic and biharmonic operators."""
    pmn = grid.pm * grid.pn
    pm_u = 0.5 * (grid.pm + st.im1(grid.pm)) * grid.umask
    pn_v = 0.5 * (grid.pn + st.jm1(grid.pn)) * grid.vmask
    cff_u = 0.25 * (d2 + st.im1(d2)) * grid.on_u
    cff_v = 0.25 * (d2 + st.jm1(d2)) * grid.om_v
    dTdx = pm_u * (q - st.im1(q))
    dTde = pn_v * (q - st.jm1(q))
    if cfg.bc.ew_periodic:
        dTdx = st.periodic_x(dTdx)
    if cfg.bc.ns_periodic:
        dTde = st.periodic_y(dTde)
    dTdz_i = (q[1:] - q[:-1]) / (z_r[1:] - z_r[:-1])
    zz = torch.zeros_like(dTdz_i[:1])
    dTdz = torch.cat([zz, dTdz_i, zz], dim=0)         # (N+1, ...)

    # horizontal fluxes with slope correction (t3dmix2_geo.h:205-245)
    mnZ = torch.clamp(dZdx, max=0.0)
    mxZ = torch.clamp(dZdx, min=0.0)
    FX = cff_u * (Hz + st.im1(Hz)) * (
        dTdx - 0.5 * (mnZ * (st.im1(dTdz)[:-1] + dTdz[1:])
                      + mxZ * (st.im1(dTdz)[1:] + dTdz[:-1])))
    mnZe = torch.clamp(dZde, max=0.0)
    mxZe = torch.clamp(dZde, min=0.0)
    FE = cff_v * (Hz + st.jm1(Hz)) * (
        dTde - 0.5 * (mnZe * (st.jm1(dTdz)[:-1] + dTdz[1:])
                      + mxZe * (st.jm1(dTdz)[1:] + dTdz[:-1])))
    if cfg.bc.ew_periodic:
        FX = st.periodic_x(FX)
    if cfg.bc.ns_periodic:
        FE = st.periodic_y(FE)

    # vertical cross-flux at interior interfaces kk=1..N-1
    # (t3dmix2_geo.h:248-278)
    c = 0.5 * d2
    dTz = dTdz[1:-1]
    c1 = torch.clamp(dZdx[:-1], max=0.0)             # layer kk-1
    c2 = torch.clamp(st.ip1(dZdx)[1:], max=0.0)      # layer kk, i+1
    c3 = torch.clamp(dZdx[1:], min=0.0)
    c4 = torch.clamp(st.ip1(dZdx)[:-1], min=0.0)
    FS = c * (c1 * (c1 * dTz - dTdx[:-1])
              + c2 * (c2 * dTz - st.ip1(dTdx)[1:])
              + c3 * (c3 * dTz - dTdx[1:])
              + c4 * (c4 * dTz - st.ip1(dTdx)[:-1]))
    e1 = torch.clamp(dZde[:-1], max=0.0)
    e2 = torch.clamp(st.jp1(dZde)[1:], max=0.0)
    e3 = torch.clamp(dZde[1:], min=0.0)
    e4 = torch.clamp(st.jp1(dZde)[:-1], min=0.0)
    FS = FS + c * (e1 * (e1 * dTz - dTde[:-1])
                   + e2 * (e2 * dTz - st.jp1(dTde)[1:])
                   + e3 * (e3 * dTz - dTde[1:])
                   + e4 * (e4 * dTz - st.jp1(dTde)[:-1]))
    FSfull = torch.cat([zz, FS, zz], dim=0)
    return pmn * (st.dx_p(FX) + st.dy_p(FE)) + (FSfull[1:] - FSfull[:-1])


def t3dmix4_geo(cfg: ModelConfig, grid: Grid, t, t_part, Hz, z_r,
                use_kernels: bool = False):
    """Biharmonic tracer mixing rotated along geopotentials
    (t3dmix4_geo.h): the rotated harmonic triad operator applied twice
    with sqrt(tnu4) each pass, the intermediate Laplacian boundary-treated
    like the along-s biharmonic."""
    if all(d == 0.0 for d in cfg.mixing.tnu4):
        return t_part
    from ..ops import hmix as hmix_op
    fn = hmix_op.rot_div_geo if use_kernels and hmix_op.covers(cfg) \
        else hmix_op.rot_div_geo_plain
    Laps = fn(cfg, grid, t, grid.diff4, Hz, z_r) / Hz
    Laps = torch.stack([_lap_bc(cfg, cfg.bc.t, Lap) for Lap in Laps])
    return t_part - cfg.dt * fn(cfg, grid, Laps, grid.diff4, Hz, z_r)
