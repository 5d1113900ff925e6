"""Predictor (n+1/2) stage of the 3D engine (port of
roms_tpu/core/pre_step3d.py; ROMS/Nonlinear/pre_step3d.F).

t_half comes from the fused UP3/C4 tracer predictor (kernel 2,
ops/tadv.py) in its class, else from core/advection.py; the corrector
seeds t_part/u_part/v_part are
column-local tensor code.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st
from . import boundary


def tracer_predictor_coefs(cfg: ModelConfig, iic: int):
    """(cff, cff1, cff2) of the AB2 predictor blend for UP3 tracers
    (pre_step3d.F:46-56): forward Euler half step at iic == 0."""
    Gamma = 1.0 / 6.0
    if iic == 0:
        return 0.5 * cfg.dt, 1.0, 0.0
    return (1.0 - Gamma) * cfg.dt, 0.5 + Gamma, 0.5 - Gamma


def pre_step3d(cfg: ModelConfig, grid: Grid, u, v, t, t_prev,
               ru_prev, rv_prev, ru_prev2, rv_prev2,
               Hz, z_r, z_w, Huon, Hvom, W, forcing, bustr, bvstr,
               iic: int, use_kernels: bool = True, ghats=None):
    """Returns (t_half, t_part, u_part, v_part); inputs at time n,
    t_prev at n-1, ru_prev/ru_prev2 the RHS at n-1/n-2.  ghats: the
    KPP nonlocal flux Akt*ghats (NAT, N+1, Mj, Li), or None."""
    from ..ops import tadv
    from .advection import tracer_predictor
    cff, cff1, cff2 = tracer_predictor_coefs(cfg, iic)
    if tadv.covers(cfg):
        fn = tadv.predictor if use_kernels else tadv.predictor_plain
    else:
        fn = tracer_predictor
    t_half = fn(cfg, grid, t, t_prev, Huon, Hvom, W, Hz, cff, cff1, cff2)
    t_half = boundary.bc_rho(t_half, cfg.bc.t)
    return (t_half, *_seeds(cfg, grid, u, v, t, ru_prev, rv_prev,
                            ru_prev2, rv_prev2, Hz, z_w, forcing, bustr,
                            bvstr, iic, ghats))


def _seeds(cfg, grid, u, v, t, ru_prev, rv_prev, ru_prev2, rv_prev2,
           Hz, z_w, forcing, bustr, bvstr, iic, ghats):
    """Column-local corrector seeds (pre_step3d.F:700-900)."""
    if cfg.bodyforce:
        raise NotImplementedError("BODYFORCE seeds: ROADMAP Queue 1 item 7")
    dt = cfg.dt
    # tracer seed Hz*t + dt*(surface - bottom flux); lambda=1 removes
    # the interior explicit diffusion piece
    zeros_i = torch.zeros_like(Hz[:-1])
    if cfg.mixing.solar_source:
        # Paulson-Simpson penetrative shortwave at interior interfaces
        # (pre_step3d.F SOLAR_SOURCE block)
        from .lmd import swdk_frac
        swdk_i = swdk_frac(z_w[-1][None] - z_w[1:-1], cfg.mixing.jwtype)
    t_part = []
    for itrc in range(cfg.NT):
        FC_int = zeros_i
        if ghats is not None and itrc < cfg.NAT:
            # LMD_NONLOCAL: FC -= dt*(Akt*ghats) (pre_step3d.F:705-713)
            FC_int = FC_int - dt * ghats[itrc][1:-1]
        if cfg.mixing.solar_source and itrc == 0:
            FC_int = FC_int + dt * forcing.srflx[None] * swdk_i
        FCd = torch.cat([dt * forcing.btflx[itrc][None], FC_int,
                         dt * forcing.stflx[itrc][None]], dim=0)
        t_part.append(Hz * t[itrc] + (FCd[1:] - FCd[:-1]))
    t_part = torch.stack(t_part)

    # momentum seed Hz_u*u + DC0*(ca*ru_{n-1} + cb*ru_{n-2}) + stresses;
    # step3d_uv adds the AB3 lead term of r_n
    Hz_u = 0.5 * (Hz + st.im1(Hz))
    Hz_v = 0.5 * (Hz + st.jm1(Hz))
    DC0u = dt * 0.25 * (grid.pm + st.im1(grid.pm)) * \
        (grid.pn + st.im1(grid.pn))
    DC0v = dt * 0.25 * (grid.pm + st.jm1(grid.pm)) * \
        (grid.pn + st.jm1(grid.pn))
    ca = 0.0 if iic == 0 else (-0.5 if iic == 1 else -16.0 / 12.0)
    cb = 0.0 if iic <= 1 else 5.0 / 12.0
    FCu = torch.cat([dt * bustr[None], zeros_i,
                     dt * forcing.sustr[None]], dim=0)
    FCv = torch.cat([dt * bvstr[None], zeros_i,
                     dt * forcing.svstr[None]], dim=0)
    u_part = u * Hz_u + DC0u * (ca * ru_prev + cb * ru_prev2) + \
        (FCu[1:] - FCu[:-1])
    v_part = v * Hz_v + DC0v * (ca * rv_prev + cb * rv_prev2) + \
        (FCv[1:] - FCv[:-1])
    return t_part, u_part, v_part
