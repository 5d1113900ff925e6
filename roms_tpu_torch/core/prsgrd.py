"""Baroclinic pressure gradient (port of roms_tpu/core/prsgrd.py).

Splines density Jacobian (prsgrd32.h, Shchepetkin & McWilliams 2003),
the reference default 'djs'.  Its fused kernel (pallas_prsgrd) needs an
EW-periodic channel and is ported with the UPWELLING slice; this plain
path is what the closed DOUBLE_GYRE basin runs on either package.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st

_EPS = 1.0e-10


def _harmonic(a, b):
    """2ab/(a+b) where 2ab > eps, else 0 (prsgrd32.h limiter)."""
    cff = 2.0 * a * b
    good = cff > _EPS
    den = torch.where(good, a + b, torch.ones_like(a))
    return torch.where(good, cff / den, torch.zeros_like(a))


def _harmonic_z(a, b):
    return 2.0 * a * b / (a + b)


def prsgrd32(cfg: ModelConfig, grid: Grid, rho, z_r, z_w, Hz,
             eq_tide=None, Pair=None):
    """(ru, rv) in m4/s2 from the density anomaly rho (N, Mj, Li)."""
    if eq_tide is not None or Pair is not None or grid.zice is not None:
        raise NotImplementedError(
            "tidal / air-pressure pressure terms: ROADMAP Queue 1 item 6; "
            "ice-shelf pressure: ROADMAP Queue 1 item 8")
    g = cfg.g
    GRho = g / cfg.rho0
    HalfGRho = 0.5 * GRho
    OneFifth = 0.2
    OneTwelfth = 1.0 / 12.0

    dR_i = rho[1:] - rho[:-1]
    dZ_i = z_r[1:] - z_r[:-1]
    dR = torch.cat([dR_i[:1], dR_i, dR_i[-1:]], dim=0)
    dZ = torch.cat([dZ_i[:1], dZ_i, dZ_i[-1:]], dim=0)
    dRm = _harmonic(dR[1:], dR[:-1])
    dZm = _harmonic_z(dZ[1:], dZ[:-1])

    cff1 = 1.0 / (z_r[-1] - z_r[-2])
    cff2 = 0.5 * (rho[-1] - rho[-2]) * (z_w[-1] - z_r[-1]) * cff1
    P_top = g * (1.0 - cfg.sal_scalar) * z_w[-1] \
        + GRho * (rho[-1] + cff2) * (z_w[-1] - z_r[-1])
    dP = HalfGRho * ((rho[1:] + rho[:-1]) * (z_r[1:] - z_r[:-1])
                     - OneFifth * ((dRm[1:] - dRm[:-1])
                                   * (z_r[1:] - z_r[:-1]
                                      - OneTwelfth * (dZm[1:] + dZm[:-1]))
                                   - (dZm[1:] - dZm[:-1])
                                   * (rho[1:] - rho[:-1]
                                      - OneTwelfth * (dRm[1:] + dRm[:-1]))))
    csum = torch.flip(torch.cumsum(torch.flip(dP, [0]), dim=0), [0])
    P = torch.cat([P_top[None] + csum, P_top[None]], dim=0)

    aux = (z_r - st.im1(z_r)) * grid.umask
    FC = (rho - st.im1(rho)) * grid.umask
    if cfg.bc.ew_periodic:
        aux, FC = st.periodic_x(aux), st.periodic_x(FC)
    dZx = _harmonic(aux, st.ip1(aux))
    dRx = _harmonic(FC, st.ip1(FC))
    if cfg.bc.ew_periodic:
        dZx, dRx = st.periodic_x(dZx), st.periodic_x(dRx)
    ru = grid.on_u * 0.5 * (Hz + st.im1(Hz)) * (
        st.im1(P) - P - HalfGRho * (
            (rho + st.im1(rho)) * (z_r - st.im1(z_r))
            - OneFifth * ((dRx - st.im1(dRx))
                          * (z_r - st.im1(z_r)
                             - OneTwelfth * (dZx + st.im1(dZx)))
                          - (dZx - st.im1(dZx))
                          * (rho - st.im1(rho)
                             - OneTwelfth * (dRx + st.im1(dRx))))))

    auy = (z_r - st.jm1(z_r)) * grid.vmask
    FE = (rho - st.jm1(rho)) * grid.vmask
    if cfg.bc.ns_periodic:
        auy, FE = st.periodic_y(auy), st.periodic_y(FE)
    dZe = _harmonic(auy, st.jp1(auy))
    dRe = _harmonic(FE, st.jp1(FE))
    if cfg.bc.ns_periodic:
        dZe, dRe = st.periodic_y(dZe), st.periodic_y(dRe)
    rv = grid.om_v * 0.5 * (Hz + st.jm1(Hz)) * (
        st.jm1(P) - P - HalfGRho * (
            (rho + st.jm1(rho)) * (z_r - st.jm1(z_r))
            - OneFifth * ((dRe - st.jm1(dRe))
                          * (z_r - st.jm1(z_r)
                             - OneTwelfth * (dZe + st.jm1(dZe)))
                          - (dZe - st.jm1(dZe))
                          * (rho - st.jm1(rho)
                             - OneTwelfth * (dRe + st.jm1(dRe))))))
    return ru, rv
