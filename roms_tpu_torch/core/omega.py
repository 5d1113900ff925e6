"""Vertical mass flux (port of roms_tpu/core/omega.py; omega.F:200-345):
integrate the horizontal mass-flux divergence up from the bottom, then
subtract the moving-coordinate drift so W vanishes at the surface; and
the true vertical velocity of the history stream (wvelocity.F).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops import stencil as st
from . import boundary


def omega(cfg: ModelConfig, grid, Huon, Hvom, z_w):
    """W at interfaces (N+1, Mj, Li); W[0] = W[N] = 0."""
    div = (st.ip1(Huon) - Huon) + (st.jp1(Hvom) - Hvom)
    Wk = -torch.cumsum(div, dim=0)
    W = torch.cat([torch.zeros_like(Wk[:1]), Wk], dim=0)
    wrk = W[-1] / (z_w[-1] - z_w[0])
    W = W - wrk[None] * (z_w - z_w[:1])
    W[-1] = 0.0
    return boundary.bc_rho(W, cfg.bc.zeta)


def mass_flux_omega(cfg: ModelConfig, grid, u, v, Hz, z_w,
                    use_kernels: bool = True):
    """(Huon, Hvom, W) of a state's u, v for the write-time diagnostics:
    kernel 7 (ops/flux.py `flux_omega`) where its class covers the
    configuration and kernels are on, else set_massflux with the
    periodic ring refresh, then omega."""
    from ..grid.depth import set_massflux
    from ..ops import flux as flux_op
    if use_kernels and flux_op.covers(cfg):
        return flux_op.flux_omega(cfg, grid, u, v, Hz, z_w)
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    if cfg.bc.ew_periodic:
        Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    if cfg.bc.ns_periodic:
        Huon, Hvom = st.periodic_y(Huon), st.periodic_y(Hvom)
    return Huon, Hvom, omega(cfg, grid, Huon, Hvom, z_w)


def wvelocity(cfg: ModelConfig, grid, u, v, W, z_r, z_w, DU_avg1, DV_avg1):
    """True vertical velocity for output (ROMS/Nonlinear/wvelocity.F):
    wvel = pm*pn*(W + drift correction) + the 4th-order interpolation of
    the grid-slope contribution vert = u dz/dxi pm + v dz/deta pn.
    Returns (N+1, Mj, Li) at interfaces."""
    pm, pn = grid.pm, grid.pn
    pmn = pm * pn
    N = cfg.N

    # slope contribution at rho levels (wvelocity.F:110-135)
    wrku = u * (z_r - st.im1(z_r)) * (pm + st.im1(pm))
    wrkv = v * (z_r - st.jm1(z_r)) * (pn + st.jm1(pn))
    if cfg.bc.ew_periodic:
        wrku = st.periodic_x(wrku)
    if cfg.bc.ns_periodic:
        wrkv = st.periodic_y(wrkv)
    vert = 0.25 * (wrku + st.ip1(wrku)) + 0.25 * (wrkv + st.jp1(wrkv))

    # barotropic drift correction (wvelocity.F:143-147)
    wrk = (DU_avg1 - st.ip1(DU_avg1) + DV_avg1 - st.jp1(DV_avg1)) / \
        (z_w[-1] - z_w[0])

    c1, c2, c3 = 3.0 / 8.0, 3.0 / 4.0, 1.0 / 8.0
    c4, c5 = 9.0 / 16.0, 1.0 / 16.0
    base = pmn[None] * (W + wrk[None] * (z_w - z_w[:1]))

    # 4th-order interface interpolation of vert (levels are 1-based in
    # the reference; vert[k] here is 0-based level k)
    wvel = torch.zeros_like(W)
    slope_b = (z_r[0] - z_w[0]) / (z_r[1] - z_r[0])
    wvel[0] = c1 * (vert[0] - slope_b * (vert[1] - vert[0])) \
        + c2 * vert[0] - c3 * vert[1]
    wvel[1] = base[1] + c1 * vert[0] + c2 * vert[1] - c3 * vert[2]
    wvel[2:N - 1] = base[2:N - 1] + c4 * (vert[1:N - 2] + vert[2:N - 1]) \
        - c5 * (vert[0:N - 3] + vert[3:N])
    wvel[N - 1] = base[N - 1] + c1 * vert[N - 1] + c2 * vert[N - 2] \
        - c3 * vert[N - 3]
    slope_t = (z_w[-1] - z_r[-1]) / (z_r[-1] - z_r[-2])
    wvel[N] = pmn * wrk * (z_w[-1] - z_w[0]) \
        + c1 * (vert[-1] + slope_t * (vert[-1] - vert[-2])) \
        + c2 * vert[-1] - c3 * vert[-2]
    return boundary.bc_rho(wvel, cfg.bc.zeta)
