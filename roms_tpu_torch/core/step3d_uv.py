"""Corrector for 3D momentum (port of roms_tpu/core/step3d_uv.py;
step3d_uv.F): AB3 lead term, spline implicit vertical viscosity,
replacement of the vertical mean by the fast-time-averaged transport
DU_avg1, and time-centred mass fluxes consistent with DU_avg2.

Runs in roms_tpu's fused order (`_step3d_uv_pallas`): solve (kernel 4a)
-> bc_u/bc_v -> finish (kernel 4b) -> ubar/vbar BCs.  Outside kernel
4's class (NS-periodic grids) the step takes the plain versions, whose
arithmetic is roms_tpu's jnp route's (correct, BCs, correct, ring wrap),
and wraps the new u, v, Huon and Hvom across the NS seam.
"""

from __future__ import annotations

from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st
from . import boundary


def ab3_lead(cfg: ModelConfig, iic: int) -> float:
    """AB3 lead coefficient cffab (step3d_uv.F:261-268)."""
    dt = cfg.dt
    if iic == 0:
        return 0.25 * dt
    if iic == 1:
        return 0.25 * dt * 1.5
    return 0.25 * dt * 23.0 / 12.0


def step3d_uv(cfg: ModelConfig, grid: Grid, u_part, v_part, ru, rv,
              Hz, Akv, avg, Huon_old, Hvom_old, iic: int,
              use_kernels: bool = True):
    """Returns (u, v, ubar, vbar, Huon, Hvom) at time n+1; Hz is the
    NEW thickness, avg the FastAverages of the fast loop."""
    if not cfg.mixing.splines_vvisc or cfg.omega_implicit:
        raise NotImplementedError(
            "non-spline viscosity / OMEGA_IMPLICIT corrector: ROADMAP "
            "Queue 1 item 7")
    from ..ops import uv
    kern = use_kernels and uv.covers(cfg)
    solve = uv.uv_solve if kern else uv.uv_solve_plain
    finish = uv.uv_finish if kern else uv.uv_finish_plain
    un, vn = solve(cfg, grid, u_part, v_part, ru, rv, Hz, Akv,
                   ab3_lead(cfg, iic), avg.DU_avg1, avg.DV_avg1)
    un = boundary.bc_u(un, cfg.bc.u, cfg.gamma2)
    vn = boundary.bc_v(vn, cfg.bc.v, cfg.gamma2)
    un, vn, ubar, vbar, Huon, Hvom = finish(
        cfg, grid, un, vn, Hz, Huon_old, Hvom_old,
        avg.DU_avg1, avg.DV_avg1, avg.DU_avg2, avg.DV_avg2)
    if cfg.bc.ew_periodic:
        un, vn = st.periodic_x(un), st.periodic_x(vn)
    if cfg.bc.ns_periodic:
        un, vn = st.periodic_y(un), st.periodic_y(vn)
        Huon, Hvom = st.periodic_y(Huon), st.periodic_y(Hvom)
    ubar = boundary.bc_u(ubar, cfg.bc.ubar, cfg.gamma2)
    vbar = boundary.bc_v(vbar, cfg.bc.vbar, cfg.gamma2)
    return un, vn, ubar, vbar, Huon, Hvom
