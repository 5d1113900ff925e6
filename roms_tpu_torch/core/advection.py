"""Tracer advection fluxes (port of roms_tpu/core/advection.py).

This slice carries the reference defaults: UPSTREAM3 and CENTERED4
horizontal fluxes and the CENTERED4 vertical flux (pre_step3d.F:
262-650, step3d_t.F:343-1205), and the tracer predictor and corrector
built on them, in roms_tpu's jnp association with its ring rows.  The
fused all-tracer update is kernel 2 (ops/tadv.py), whose plain version
is these updates with rows j = 0 and Mj-1 zeroed; the step takes the
updates here outside the kernel's class (NS-periodic grids, where those
rows are live).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, UPSTREAM3, CENTERED4
from ..grid.grid import Grid
from ..ops import stencil as st


def hadv_flux(cfg: ModelConfig, grid: Grid, q, Huon, Hvom, scheme: str):
    """Horizontal advective fluxes (FX at U points, FE at V points) for
    q (..., Mj, Li), with the non-periodic edge clamps of the gradient
    scratch arrays."""
    ewp = cfg.bc.ew_periodic
    nsp = cfg.bc.ns_periodic
    dqx = (q - st.im1(q)) * grid.umask
    dqe = (q - st.jm1(q)) * grid.vmask

    if scheme == UPSTREAM3:
        curvx = st.ip1(dqx) - dqx
        curve = st.jp1(dqe) - dqe
        curvx = st.periodic_x(curvx) if ewp else \
            st.zero_east(st.zero_west(curvx))
        curve = st.periodic_y(curve) if nsp else \
            st.zero_north(st.zero_south(curve))
        sixth = 1.0 / 6.0
        FX = Huon * 0.5 * (q + st.im1(q)) - sixth * (
            st.im1(curvx) * torch.clamp(Huon, min=0.0)
            + curvx * torch.clamp(Huon, max=0.0))
        FE = Hvom * 0.5 * (q + st.jm1(q)) - sixth * (
            st.jm1(curve) * torch.clamp(Hvom, min=0.0)
            + curve * torch.clamp(Hvom, max=0.0))
        return FX, FE

    if scheme != CENTERED4:
        raise NotImplementedError(
            f"horizontal tracer advection '{scheme}': ROADMAP Queue 1 "
            "item 7")
    gx = 0.5 * (st.ip1(dqx) + dqx)
    ge = 0.5 * (st.jp1(dqe) + dqe)
    if ewp:
        gx = st.periodic_x(gx)
    else:
        gx = st.clamp_east(st.clamp_west(gx, col=1, at=0, src=dqx),
                           col=-1, at=-1, src=dqx)
    if nsp:
        ge = st.periodic_y(ge)
    else:
        ge = st.clamp_north(st.clamp_south(ge, row=1, src=dqe),
                            row=-1, src=dqe)
    third = 1.0 / 3.0
    FX = Huon * 0.5 * (q + st.im1(q) - third * (gx - st.im1(gx)))
    FE = Hvom * 0.5 * (q + st.jm1(q) - third * (ge - st.jm1(ge)))
    return FX, FE


def vadv_flux(cfg: ModelConfig, q, W, Hz, scheme: str):
    """CENTERED4 vertical flux FC at interfaces (N+1, ...), FC[0] =
    FC[N] = 0; q, Hz: (N, ...), W: (N+1, ...)."""
    if scheme != CENTERED4:
        raise NotImplementedError(
            f"vertical tracer advection '{scheme}': ROADMAP Queue 1 "
            "item 7")
    N = q.shape[0]
    zeros = torch.zeros_like(q[:1])
    cff1, cff2, cff3 = 0.5, 7.0 / 12.0, 1.0 / 12.0
    FCi = W[2:-2] * (cff2 * (q[1:-2] + q[2:-1])
                     - cff3 * (q[:-3] + q[3:]))
    FC1 = W[1] * (cff1 * q[0] + cff2 * q[1] - cff3 * q[2])
    FCn = W[N - 1] * (cff1 * q[-1] + cff2 * q[-2] - cff3 * q[-3])
    return torch.cat([zeros, FC1[None], FCi, FCn[None], zeros], dim=0)


def _divergences(cfg: ModelConfig, grid: Grid, itrc: int, q, Huon, Hvom,
                 W, Hz):
    """The horizontal and vertical flux divergences of tracer itrc's
    field q, with the tracer's own schemes."""
    FX, FE = hadv_flux(cfg, grid, q, Huon, Hvom, cfg.tracer_hadv(itrc))
    FC = vadv_flux(cfg, q, W, Hz, cfg.tracer_vadv(itrc))
    return st.dx_p(FX) + st.dy_p(FE), FC[1:] - FC[:-1]


def tracer_predictor(cfg: ModelConfig, grid: Grid, t, t_prev, Huon, Hvom,
                     W, Hz, cff, cff1, cff2):
    """t_half of all tracers before bc_rho (pre_step3d.F:260-700): the
    AB2 blend advected by half a step over the implied new thickness."""
    pmn = grid.pm * grid.pn
    out = []
    for itrc in range(cfg.NT):
        hdiv, vdiv = _divergences(cfg, grid, itrc, t[itrc], Huon, Hvom, W,
                                  Hz)
        th = Hz * (cff1 * t[itrc] + cff2 * t_prev[itrc]) - \
            cff * pmn * hdiv
        DC = 1.0 / (Hz - cff * pmn * (st.dx_p(Huon) + st.dy_p(Hvom)
                                      + (W[1:] - W[:-1])))
        out.append(DC * (th - cff * pmn * vdiv))
    return torch.stack(out)


def tracer_corrector(cfg: ModelConfig, grid: Grid, t_half, t_part, Huon,
                     Hvom, W, Hz):
    """Pre-diffusion Hz-weighted tn of all tracers (step3d_t.F:
    343-1205): t_part - dt*pmn*(hdiv + vdiv), added in that order."""
    pmn = grid.pm * grid.pn
    out = []
    for itrc in range(cfg.NT):
        hdiv, vdiv = _divergences(cfg, grid, itrc, t_half[itrc], Huon,
                                  Hvom, W, Hz)
        tn = t_part[itrc] + -cfg.dt * pmn * hdiv
        out.append(tn + -cfg.dt * pmn * vdiv)
    return torch.stack(out)
