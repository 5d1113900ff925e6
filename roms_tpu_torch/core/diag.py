"""Global diagnostics and blowup detection (port of roms_tpu/core/diag.py).

Re-implements ROMS/Nonlinear/diag.F:103-320: basin-integrated volume,
kinetic/potential energy, maximum absolute velocity and maximum Courant
number.  The blowup criterion mirrors mod_scalars.F:548-580: |speed| >
MAX_SPEED, Courant > MAX_COURANT, rho > MAX_RHO, or non-finite ->
exit_flag 1 (ExitFlag.BLOWS_UP); the full 0-9 taxonomy lives in
core/errors.py.

Courant number (diag.F:243-249): C = Cu + Cv + Cw with
  Cu = 0.5*|u(i)+u(i+1)|*dt*pm,  Cv = 0.5*|v(j)+v(j+1)|*dt*pn,
  Cw = 0.5*|wvel(k-1)+wvel(k)|*dt/Hz,
where wvel ~ pm*pn*W is the physical vertical velocity at interfaces.

W and rho are recomputed from the state on the step's own routes: the
EOS through kernel 1's wrapper and the mass fluxes with omega through
kernel 7's where its class covers the configuration (`use_kernels=True`,
core/omega.py `mass_flux_omega`), so a diagnostics call on the card runs
no kernel's plain version.  Every value stays a 0-d tensor on the
state's device until the caller reads it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st
from .errors import ExitFlag


class Diagnostics(NamedTuple):
    volume: torch.Tensor        # basin volume (m3)
    avgke: torch.Tensor         # mean kinetic energy per unit mass (m2/s2)
    avgpe: torch.Tensor         # mean potential energy per unit mass
    max_speed: torch.Tensor     # max |(u,v)| (m/s)
    max_courant: torch.Tensor   # max 3D Courant number Cu+Cv+Cw
    max_courant_w: torch.Tensor  # vertical part at the same criterion
    max_rho: torch.Tensor       # max density anomaly (kg/m3)
    exit_flag: torch.Tensor     # ExitFlag: 0 ok; 1 blowup
    blowup_cause: torch.Tensor  # 0 none; 1 nonfinite; 2 speed; 3 CFL; 4 rho


# blowup thresholds (roms_tpu's defaults of diag)
MAX_SPEED = 20.0      # m/s
MAX_COURANT = 10.0
MAX_RHO = 200.0       # kg/m3


def diag(cfg: ModelConfig, grid: Grid, state,
         use_kernels: bool = True) -> Diagnostics:
    """Global diagnostics of a model State."""
    from .omega import mass_flux_omega
    from .rho_eos import rho_eos
    u, v, zeta, Hz = state.u, state.v, state.zeta, state.Hz
    interior = grid.rmask.clone()
    interior[0, :] = 0.0
    interior[-1, :] = 0.0
    interior[:, 0] = 0.0
    interior[:, -1] = 0.0
    omn = 1.0 / (grid.pm * grid.pn) * interior

    cell_vol = Hz * omn[None]
    volume = torch.sum(cell_vol)

    u_r = 0.5 * (u + st.ip1(u))          # u at rho
    v_r = 0.5 * (v + st.jp1(v))
    ke = 0.5 * (u_r * u_r + v_r * v_r)
    avgke = torch.sum(ke * cell_vol) / volume

    pe = 0.5 * cfg.g * zeta * zeta
    avgpe = torch.sum(pe * omn) / torch.sum((zeta + grid.h) * omn)

    speed = torch.sqrt(u_r * u_r + v_r * v_r)
    spd_max = torch.max(speed * interior[None])

    W = mass_flux_omega(cfg, grid, u, v, Hz, state.z_w, use_kernels)[2]
    cu_half = torch.abs(u + st.ip1(u))    # |u(i)+u(i+1)| at rho
    cv_half = torch.abs(v + st.jp1(v))
    Cu = 0.5 * cfg.dt * cu_half * grid.pm[None]
    Cv = 0.5 * cfg.dt * cv_half * grid.pn[None]
    wvel = (grid.pm * grid.pn)[None] * W
    Cw = 0.5 * cfg.dt * torch.abs(wvel[:-1] + wvel[1:]) / Hz
    C = (Cu + Cv + Cw) * interior[None]
    cmax = torch.max(C)
    # vertical component at the argmax cell (diag.F reports Cw of the
    # max-C location; a flat argmax over the masked array)
    cmax_w = (Cw * interior[None]).reshape(-1)[torch.argmax(C.reshape(-1))]

    rho = rho_eos(cfg, state.t, state.z_r, Hz, state.z_w,
                  use_kernels=use_kernels)[0]
    rho_max = torch.max(rho * interior[None])

    finite = (torch.isfinite(spd_max) & torch.isfinite(avgke)
              & torch.isfinite(torch.sum(zeta * interior)))
    over_speed = spd_max > MAX_SPEED
    over_cfl = cmax > MAX_COURANT
    over_rho = rho_max > MAX_RHO
    blown = (~finite) | over_speed | over_cfl | over_rho
    cause = torch.where(~finite, 1, torch.where(
        over_speed, 2, torch.where(over_cfl, 3, torch.where(
            over_rho, 4, 0)))).to(torch.int32)
    return Diagnostics(volume=volume, avgke=avgke, avgpe=avgpe,
                       max_speed=spd_max, max_courant=cmax,
                       max_courant_w=cmax_w, max_rho=rho_max,
                       exit_flag=blown.to(torch.int32) *
                       int(ExitFlag.BLOWS_UP),
                       blowup_cause=cause)


_CAUSES = {0: "none", 1: "non-finite field", 2: "max |v| exceeded",
           3: "max Courant exceeded", 4: "max rho exceeded"}


def blowup_string(d: Diagnostics) -> str:
    """Human-readable blowup report (mod_scalars blowup_string)."""
    cause = _CAUSES[int(d.blowup_cause)]
    return (f"exit_flag={int(d.exit_flag)} cause={cause} "
            f"speed={float(d.max_speed):.3e} C={float(d.max_courant):.3e} "
            f"Cw={float(d.max_courant_w):.3e} rho={float(d.max_rho):.3e}")
