"""Mellor-Yamada level-2.5 turbulence closure (port of
roms_tpu/core/my25.py; my25_prestep.F and my25_corstep.F).

q2 = tke (twice the turbulent kinetic energy) and q2l = gls (tke times
the master length scale) live at w-interfaces and advect exactly like
the GLS pair (the prestep is core/gls.py gls_prestep), with
shear/buoyancy production (my25_corstep.F:600-624), implicit
dissipation and the Blumberg wall-proximity factor (:626-636), the
Dirichlet boundary values folded into the first and last interior
equations (:645-655), and the Galperin-limited length scale and
stability functions (:700-770).  Its four solves a step (two in
`shear2_spline`, the q2 and q2l solves) go through kernel 17 by
core/gls.py `closure_solve`, as in GLS.

Constants from mod_scalars.F:1846-1875, derived products from
mod_scalars.F:4753-4766.
"""

from __future__ import annotations

import torch

from .. import constants
from ..config import ModelConfig
from ..grid.grid import Grid
from ..ops import stencil as st
from .gls import (MixState, _assemble, _bc_w, _stress_mag, closure_solve,
                  corstep_advect, initial_mix, n2s2_horavg, shear2_spline)

# mod_scalars.F:1846-1859
A1, A2, B1, B2 = 0.92, 0.74, 16.6, 10.1
C1, C2, C3 = 0.08, 0.7, 0.2
E1, E2 = 1.8, 1.33
GH0 = 0.0233
SQ = 0.2
LMAX = 0.53
QMIN = 1.0e-8
_EPS = 1.0e-10

# derived (mod_scalars.F:4753-4766)
B1P2O3 = B1 ** (2.0 / 3.0)
B1PM1O3 = B1 ** (-1.0 / 3.0)
SH1 = A2 * (1.0 - 6.0 * A1 / B1)
SM2 = 9.0 * A1 * A2
SM3 = A1 * (1.0 - 3.0 * C1 - 6.0 * A1 / B1)
SM4_KC = 18.0 * A1 * A1 + 9.0 * A1 * A2 * (1.0 - C2)
# Kantha & Clayson Sh denominator constant (mod_scalars.F:4762 branch)
SH2_KC = 3.0 * A2 * (6.0 * A1 + B2 * (1.0 - C3))
SH2_GALP = 3.0 * A2 * (6.0 * A1 + B2)


def initial_mix_my25(cfg: ModelConfig, device) -> MixState:
    """MixState seeded with the MY2.5 minimum levels (my_qmin)."""
    mix = initial_mix(cfg, device)
    q = torch.full_like(mix.tke, QMIN)
    return mix._replace(tke=q, tke_prev=q, gls=q, gls_prev=q)


def my25_corstep(cfg: ModelConfig, grid: Grid, mix: MixState,
                 tke_half, gls_half, tke_seed, gls_seed,
                 u, v, Hz, z_r, z_w, Huon, Hvom, W, bvf,
                 sustr, svstr, bustr, bvstr,
                 use_kernels: bool = True) -> MixState:
    """my25_corstep.F; interface fields live at w-points with prognostic
    interior interfaces k=1..N-1."""
    m = cfg.mixing
    dt = cfg.dt
    vonKar = constants.vonKar
    NAT = cfg.NAT
    kc = m.gls_stab != "galperin"

    # ---- shear^2 / N^2 at interior interfaces with smoothing ------------
    shear2 = n2s2_horavg(cfg, shear2_spline(u, v, Hz, use_kernels))
    buoy2 = n2s2_horavg(cfg, bvf[1:-1])

    # ---- corrector advection of the Hz-weighted pair ---------------------
    tke_n, gls_n = corstep_advect(cfg, grid, tke_half, gls_half,
                                  tke_seed, gls_seed, Huon, Hvom, W)

    # ---- production (my25_corstep.F:600-624) -----------------------------
    q2_old = torch.clamp(mix.tke[1:-1], min=QMIN)
    q2l_old = torch.clamp(mix.gls[1:-1], min=QMIN)
    Akv_i = mix.Akv[1:-1]
    Akt_i = mix.Akt[0][1:-1]
    strat2 = torch.where((buoy2 > -5.0e-5) & (buoy2 < 0.0),
                         torch.zeros_like(buoy2), buoy2)
    Qprod = shear2 * (Akv_i - m.akv_bak) - strat2 * (Akt_i - m.akt_bak[0])
    Ls_unlmt = torch.clamp(q2l_old / q2_old, min=_EPS)
    Hz_w = 0.5 * (Hz[:-1] + Hz[1:])
    tke_n = tke_n + dt * Hz_w * Qprod * 2.0
    gls_n = gls_n + dt * Hz_w * Qprod * E1 * Ls_unlmt

    # ---- implicit dissipation + wall function (:626-636) -----------------
    Qdiss = dt * torch.sqrt(q2_old) / (B1 * Ls_unlmt)
    d_bot = torch.clamp(z_w[1:-1] - z_w[:1], min=_EPS)
    d_top = torch.clamp(z_w[-1:] - z_w[1:-1], min=_EPS)
    cffw = Ls_unlmt * (1.0 / d_top + 1.0 / d_bot)
    Wscale = 1.0 + (E2 / vonKar ** 2) * cffw * cffw
    # FCK(k) = -0.5*dt*(Akk(k)+Akk(k-1))/Hz(k) through layer k couples
    # interfaces k-1 and k; unlike GLS (flux BCs), MY2.5 keeps the
    # Dirichlet couplings to the boundary interfaces (my25_corstep.F:
    # 586-664)
    FCK_full = -0.5 * dt * (mix.Akk[1:] + mix.Akk[:-1]) / Hz  # (N,...)
    zK = torch.zeros_like(FCK_full[:1])
    lowK = torch.cat([zK, FCK_full[1:-1]], dim=0)
    upK = torch.cat([FCK_full[1:-1], zK], dim=0)
    couple = FCK_full[:-1] + FCK_full[1:]
    diagK = Hz_w * (1.0 + 2.0 * Qdiss) - couple
    diagP = Hz_w * (1.0 + Wscale * Qdiss) - couple

    # ---- Dirichlet boundary values (:645-655) ----------------------------
    taus = _stress_mag(sustr, svstr, st.ip1(sustr), st.jp1(svstr))
    taub = _stress_mag(bustr, bvstr, st.ip1(bustr), st.jp1(bvstr))
    q2_sfc = B1P2O3 * taus
    q2_bot = B1P2O3 * taub
    # fold the Dirichlet rows into the first/last interior equations
    tke_rhs = tke_n.clone()
    tke_rhs[-1] = tke_rhs[-1] + (-FCK_full[-1] * q2_sfc)
    tke_rhs[0] = tke_rhs[0] + (-FCK_full[0] * q2_bot)

    q2_new = closure_solve(lowK, diagK, upK, tke_rhs, use_kernels)
    q2l_new = closure_solve(lowK, diagP, upK, gls_n, use_kernels)
    q2_new = torch.clamp(q2_new, min=QMIN)
    q2l_new = torch.clamp(q2l_new, min=QMIN)

    # ---- length scale + stability functions (:700-770) -------------------
    Ls = q2l_new / q2_new
    Ls_lmt = torch.minimum(
        Ls, LMAX * torch.sqrt(q2_new / (torch.clamp(buoy2, min=0.0)
                                        + _EPS)))
    Gh = torch.clamp(-buoy2 * Ls_lmt * Ls_lmt / q2_new, max=GH0)
    Sh = SH1 / (1.0 - (SH2_KC if kc else SH2_GALP) * Gh)
    if kc:
        Sm = (B1PM1O3 + Sh * Gh * SM4_KC) / (1.0 - SM2 * Gh)
    else:
        Sm = (SM3 + Sh * Gh * SM4_KC) / (1.0 - SM2 * Gh)
    ql = 0.5 * (Ls_lmt * torch.sqrt(q2_new)
                + mix.Lscale[1:-1] * torch.sqrt(q2_old))
    Akv_new_i = m.akv_bak + ql * Sm
    Akt_new_i = ql * Sh
    Akk_new_i = m.akk_bak + ql * SQ

    def const(val):
        return torch.full_like(q2_sfc, val)

    return MixState(
        tke=_bc_w(cfg, _assemble(q2_new, torch.clamp(q2_bot, min=QMIN),
                                 torch.clamp(q2_sfc, min=QMIN))),
        tke_prev=mix.tke,
        gls=_bc_w(cfg, _assemble(q2l_new, const(QMIN), const(QMIN))),
        gls_prev=mix.gls,
        Akv=_bc_w(cfg, _assemble(Akv_new_i, const(m.akv_bak),
                                 const(m.akv_bak))),
        Akt=_bc_w(cfg, torch.stack([
            _assemble(m.akt_bak[it] + Akt_new_i, const(m.akt_bak[it]),
                      const(m.akt_bak[it])) for it in range(NAT)])),
        Akk=_bc_w(cfg, _assemble(Akk_new_i, const(m.akk_bak),
                                 const(m.akk_bak))),
        Akp=mix.Akp,
        Lscale=_assemble(Ls_lmt, const(1.0e-6), const(1.0e-6)))
