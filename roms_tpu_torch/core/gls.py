"""Generic length scale (GLS) turbulence closure (port of
roms_tpu/core/gls.py; Umlauf & Burchard 2003; gls_prestep.F and
gls_corstep.F).

AB2 predictor advection of TKE/psi at w-interfaces, corrector advection
with shear/buoyancy production, implicit vertical solves along k, the
Galperin limiter and the Canuto-A / Kantha-Clayson stability functions
that deliver Akv/Akt.  TKE and psi live at w-interfaces (N+1 levels);
the prognostic cells are the interior interfaces k=1..N-1 with
Dirichlet surface/bottom values from the stress balance
(gls_corstep.F:655-700).

The four solves of a step (two in `shear2_spline`, the TKE and psi
solves of `gls_corstep`) go through `closure_solve`: kernel 17's
wrapper (ops/tridiag.py tridiag_solve) with the Model's `use_kernels`
where the kernel's class covers the column depth.
Every expression keeps roms_tpu's operation order: threshold tests
(`buoy2_a > 0`, `neg_K`, `neg_P`, the Galperin limiter) must see the
same roundings.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import constants
from ..config import MixingConfig, ModelConfig
from ..device import torch_dtype
from ..grid.grid import Grid
from ..ops import stencil as st
from ..ops import tridiag as tridiag_op
from . import boundary

# --- closure constants (mod_scalars.F:1769-1795, 1846-1859, 4728-4767) ---
_EPS = 1.0e-10

# Canuto-A (mod_scalars.F:1769-1778)
_CA = dict(Gh0=0.0329, Ghcri=0.03, L1=0.107, L2=0.0032, L3=0.0864,
           L4=0.12, L5=11.9, L6=0.4, L7=0.0, L8=0.48)
_GHMIN = -0.28
_GLS_E2 = 1.33

# Mellor-Yamada constants for Kantha-Clayson stability functions
_MY = dict(A1=0.92, A2=0.74, B1=16.6, B2=10.1, C1=0.08, C2=0.7, C3=0.2)


def _canuto_a_coeffs():
    L = _CA
    s0 = 1.5 * L["L1"] * L["L5"] ** 2
    s1 = (-L["L4"] * (L["L6"] + L["L7"])
          + 2.0 * L["L4"] * L["L5"] * (L["L1"] - L["L2"] / 3.0 - L["L3"])
          + 1.5 * L["L1"] * L["L5"] * L["L8"])
    s2 = -3.0 / 8.0 * L["L1"] * (L["L6"] ** 2 - L["L7"] ** 2)
    s4 = 2.0 * L["L5"]
    s5 = 2.0 * L["L4"]
    s6 = (2.0 / 3.0 * L["L5"] * (3.0 * L["L3"] ** 2 - L["L2"] ** 2)
          - 0.5 * L["L5"] * L["L1"] * (3.0 * L["L3"] - L["L2"])
          + 0.75 * L["L1"] * (L["L6"] - L["L7"]))
    b0 = 3.0 * L["L5"] ** 2
    b1 = L["L5"] * (7.0 * L["L4"] + 3.0 * L["L8"])
    b2 = (L["L5"] ** 2 * (3.0 * L["L3"] ** 2 - L["L2"] ** 2)
          - 0.75 * (L["L6"] ** 2 - L["L7"] ** 2))
    b3 = L["L4"] * (4.0 * L["L4"] + 3.0 * L["L8"])
    b5 = 0.25 * (L["L2"] ** 2 - 3.0 * L["L3"] ** 2) * \
        (L["L6"] ** 2 - L["L7"] ** 2)
    b4 = (L["L4"] * (L["L2"] * L["L6"] - 3.0 * L["L3"] * L["L7"]
                     - L["L5"] * (L["L2"] ** 2 - L["L3"] ** 2))
          + L["L5"] * L["L8"] * (3.0 * L["L3"] ** 2 - L["L2"] ** 2))
    return dict(s0=s0, s1=s1, s2=s2, s4=s4, s5=s5, s6=s6,
                b0=b0, b1=b1, b2=b2, b3=b3, b4=b4, b5=b5)


class MixState(NamedTuple):
    """Prognostic turbulence fields (mod_mixing.F:179-238)."""
    tke: torch.Tensor        # (N+1, Mj, Li) at time n
    tke_prev: torch.Tensor   # time n-1 (AB2 history)
    gls: torch.Tensor
    gls_prev: torch.Tensor
    Akv: torch.Tensor        # (N+1, Mj, Li)
    Akt: torch.Tensor        # (NAT, N+1, Mj, Li)
    Akk: torch.Tensor        # diffusivity of tke
    Akp: torch.Tensor        # diffusivity of gls
    Lscale: torch.Tensor     # dissipative length scale


def initial_mix(cfg: ModelConfig, device) -> MixState:
    m = cfg.mixing
    dtype = torch_dtype(cfg.dtype)
    shp = (cfg.N + 1,) + cfg.shape2d

    def full(val):
        return torch.full(shp, val, dtype=dtype, device=device)

    tke = full(m.gls_kmin)
    gls = full(m.gls_pmin)
    return MixState(tke=tke, tke_prev=tke, gls=gls, gls_prev=gls,
                    Akv=full(m.akv_bak),
                    Akt=torch.stack([full(ab) for ab in m.akt_bak]),
                    Akk=full(m.akk_bak), Akp=full(m.akp_bak),
                    Lscale=full(1.0e-6))


def _bc_w(cfg, f):
    """tkebc gradient-at-edges + periodic (tkebc_im.F semantics for the
    closed/periodic family)."""
    return boundary.bc_rho(f, cfg.bc.tke)


def _hadv_interface(cfg, grid, q, Huon, Hvom, Gadv=-0.25):
    """3rd-order upstream-biased horizontal fluxes of an interface field
    at interfaces 1..N-1 (gls_corstep.F '#else' branch), flux velocity
    0.5*(Huon[k]+Huon[k+1]).  q: (N-1, Mj, Li); Huon: (N, Mj, Li)."""
    XF = 0.5 * (Huon[:-1] + Huon[1:])
    EF = 0.5 * (Hvom[:-1] + Hvom[1:])
    dqx = (q - st.im1(q)) * grid.umask
    dqe = (q - st.jm1(q)) * grid.vmask
    curvx = st.ip1(dqx) - dqx
    curve = st.jp1(dqe) - dqe
    if cfg.bc.ew_periodic:
        curvx = st.periodic_x(curvx)
    else:
        curvx = st.zero_east(st.zero_west(curvx))
    if cfg.bc.ns_periodic:
        curve = st.periodic_y(curve)
    else:
        curve = st.zero_south(st.zero_north(curve))
    upx = torch.where(XF > 0.0, st.im1(curvx), curvx)
    upe = torch.where(EF > 0.0, st.jm1(curve), curve)
    FX = XF * 0.5 * (q + st.im1(q) - Gadv * upx)
    FE = EF * 0.5 * (q + st.jm1(q) - Gadv * upe)
    return FX, FE


def _vflux(Wc, qq, N):
    """C4-ish vertical fluxes at rho levels 1..N of an interface field,
    flux velocity Wc = 0.5*(W[k]+W[k-1]) (gls_prestep '#else' branch)."""
    c71, c112 = 7.0 / 12.0, 1.0 / 12.0
    Fi = Wc[1:-1] * (c71 * (qq[1:-2] + qq[2:-1])
                     - c112 * (qq[:-3] + qq[3:]))
    F1 = Wc[0] * (qq[0] / 3.0 + 5.0 / 6.0 * qq[1] - qq[2] / 6.0)
    Fn = Wc[-1] * (qq[N] / 3.0 + 5.0 / 6.0 * qq[N - 1] - qq[N - 2] / 6.0)
    return torch.cat([F1[None], Fi, Fn[None]], dim=0)


def gls_prestep(cfg: ModelConfig, grid: Grid, mix: MixState,
                Huon, Hvom, W, Hz, iic: int):
    """Predictor for tke/gls (gls_prestep.F).

    Returns (tke_half, gls_half, tke_seed, gls_seed): the half fields
    are interface values at n+1/2 (full N+1 levels; boundary levels
    copied from time n), the seeds Hz_w * q(n) for the corrector's
    implicit solve.  `iic` is a host int."""
    dt = cfg.dt
    pmn = grid.pm * grid.pn
    N = cfg.N
    Gamma = 1.0 / 6.0
    if iic == 0:
        cff1, cff2, cff3 = 1.0, 0.0, 0.5 * dt
    else:
        cff1, cff2, cff3 = 0.5 + Gamma, 0.5 - Gamma, (1.0 - Gamma) * dt

    Hz_w = 0.5 * (Hz[:-1] + Hz[1:])       # (N-1,...) at interfaces 1..N-1
    q_int = mix.tke[1:-1]
    p_int = mix.gls[1:-1]
    q_old = mix.tke_prev[1:-1]
    p_old = mix.gls_prev[1:-1]

    FXq, FEq = _hadv_interface(cfg, grid, q_int, Huon, Hvom)
    FXp, FEp = _hadv_interface(cfg, grid, p_int, Huon, Hvom)
    XF = 0.5 * (Huon[:-1] + Huon[1:])
    EF = 0.5 * (Hvom[:-1] + Hvom[1:])

    cff4 = cff3 * pmn
    Hz_half = Hz_w - cff4 * (st.dx_p(XF) + st.dy_p(EF))
    tke_h = Hz_w * (cff1 * q_int + cff2 * q_old) - \
        cff4 * (st.dx_p(FXq) + st.dy_p(FEq))
    gls_h = Hz_w * (cff1 * p_int + cff2 * p_old) - \
        cff4 * (st.dx_p(FXp) + st.dy_p(FEp))

    Wc = 0.5 * (W[:-1] + W[1:])           # (N,...) at rho levels
    q = mix.tke
    p = mix.gls
    FCq = _vflux(Wc, q, N)
    FCp = _vflux(Wc, p, N)
    Hz_half = Hz_half - cff4 * (Wc[1:] - Wc[:-1])
    oHz_half = 1.0 / Hz_half
    tke_h = oHz_half * (tke_h - cff4 * (FCq[1:] - FCq[:-1]))
    gls_h = oHz_half * (gls_h - cff4 * (FCp[1:] - FCp[:-1]))

    tke_half = _bc_w(cfg, torch.cat([q[:1], tke_h, q[-1:]], dim=0))
    gls_half = _bc_w(cfg, torch.cat([p[:1], gls_h, p[-1:]], dim=0))
    return tke_half, gls_half, Hz_w * q_int, Hz_w * p_int


def closure_solve(lower, diag, upper, rhs, use_kernels: bool = True):
    """A closure's solve along k: kernel 17 where its class covers the
    system (ops/tridiag.py `covers`: at most NMAX interior interfaces),
    else the plain sweep, as roms_tpu's dispatcher takes its scan."""
    if tridiag_op.covers(rhs):
        return tridiag_op.tridiag_solve(lower, diag, upper, rhs,
                                        use_kernels)
    return tridiag_op.tridiag_plain(lower, diag, upper, rhs)


def shear2_spline(u, v, Hz, use_kernels: bool = True):
    """Parabolic-spline (du/dz)^2+(dv/dz)^2 at interior interfaces
    (RI_SPLINES path, gls_corstep.F:278-310 / my25_corstep.F): two
    solves of kernel 17."""
    du_c = (u[1:] - u[:-1]) + (st.ip1(u)[1:] - st.ip1(u)[:-1])
    dv_c = (v[1:] - v[:-1]) + (st.jp1(v)[1:] - st.jp1(v)[:-1])
    lo = Hz[1:-1]
    dg = 2.0 * Hz[1:] + 2.0 * Hz[:-1]
    up = Hz[1:-1]
    zpad = torch.zeros_like(lo[:1])
    lower = torch.cat([zpad, lo], dim=0)
    upper = torch.cat([up, zpad], dim=0)
    dU = closure_solve(lower, dg, upper, 3.0 * du_c, use_kernels)
    dV = closure_solve(lower, dg, upper, 3.0 * dv_c, use_kernels)
    return dU * dU + dV * dV


def n2s2_horavg(cfg, f):
    """Horizontal smoothing of N2/S2 (N2S2_HORAVG branch)."""
    fp = 0.25 * (f + st.ip1(f) + st.jp1(f) + st.ip1(st.jp1(f)))
    if cfg.bc.ew_periodic:
        fp = st.periodic_x(fp)
    if cfg.bc.ns_periodic:
        fp = st.periodic_y(fp)
    return 0.25 * (fp + st.im1(fp) + st.jm1(fp) + st.im1jm1(fp))


def corstep_advect(cfg, grid, tke_half, gls_half, tke_seed, gls_seed,
                   Huon, Hvom, W):
    """Corrector advection of the half-step interface fields shared by
    gls_corstep and my25_corstep: horizontal 3rd-order upstream + C4-ish
    vertical of Hz-weighted tke/psi.  Returns (tke_n, gls_n) >= 0."""
    dt = cfg.dt
    N = cfg.N
    pmn = grid.pm * grid.pn
    FXq, FEq = _hadv_interface(cfg, grid, tke_half[1:-1], Huon, Hvom)
    FXp, FEp = _hadv_interface(cfg, grid, gls_half[1:-1], Huon, Hvom)
    cffd = dt * pmn
    tke_n = tke_seed - cffd * (st.dx_p(FXq) + st.dy_p(FEq))
    gls_n_ = gls_seed - cffd * (st.dx_p(FXp) + st.dy_p(FEp))

    Wc = 0.5 * (W[:-1] + W[1:])
    FCq = _vflux(Wc, tke_half, N)
    FCp = _vflux(Wc, gls_half, N)
    tke_n = torch.clamp(tke_n - cffd * (FCq[1:] - FCq[:-1]), min=0.0)
    gls_n_ = torch.clamp(gls_n_ - cffd * (FCp[1:] - FCp[:-1]), min=0.0)
    return tke_n, gls_n_


def _assemble(interior, bot, sfc):
    return torch.cat([bot[None], interior, sfc[None]], dim=0)


def _stress_mag(x, y, xp, yp):
    """0.5*|tau| at rho points from U/V-point stresses."""
    return 0.5 * torch.sqrt((x + xp) ** 2 + (y + yp) ** 2)


def gls_corstep(cfg: ModelConfig, grid: Grid, mix: MixState,
                tke_half, gls_half, tke_seed, gls_seed,
                u, v, Hz, z_r, z_w, Huon, Hvom, W, bvf,
                sustr, svstr, bustr, bvstr,
                use_kernels: bool = True) -> MixState:
    """Corrector + implicit solve + stability functions (gls_corstep.F)."""
    m = cfg.mixing
    dt = cfg.dt
    vonKar = constants.vonKar
    NAT = cfg.NAT
    p_, m_, n_ = m.gls_p, m.gls_m, m.gls_n
    cmu0 = m.gls_cmu0
    Kmin, Pmin = m.gls_kmin, m.gls_pmin
    Zos_min = max(m.gls_Zos, 0.0001)
    Zob_min = max(cfg.drag.Zob, 0.0001)
    L_sft = vonKar

    cmu_fac1 = cmu0 ** (-p_ / n_)
    cmu_fac2 = cmu0 ** (3.0 + p_ / n_)
    cmu_fac3 = 1.0 / cmu0 ** 2
    gls_fac4 = cmu0 ** p_
    gls_fac5 = 0.56 ** (0.5 * n_) * cmu0 ** p_
    gls_fac6 = 8.0 / cmu0 ** 6
    gls_exp1 = 1.0 / n_
    tke_exp1 = m_ / n_
    tke_exp2 = 0.5 + m_ / n_
    tke_exp4 = m_ + 0.5 * n_
    sqrt2 = math.sqrt(2.0)

    # ---- shear^2 and N^2 at interior interfaces, smoothed ----------------
    shear2 = n2s2_horavg(cfg, shear2_spline(u, v, Hz, use_kernels))
    buoy2_a = n2s2_horavg(cfg, bvf[1:-1])

    # ---- corrector advection of half-step fields -------------------------
    tke_n, gls_n_ = corstep_advect(cfg, grid, tke_half, gls_half,
                                   tke_seed, gls_seed, Huon, Hvom, W)

    # ---- production / dissipation sources (gls_corstep.F:596-654) -------
    tke0 = mix.tke[1:-1]
    gls0 = mix.gls[1:-1]
    akv_ex = mix.Akv[1:-1] - m.akv_bak
    akt_ex = mix.Akt[0][1:-1] - m.akt_bak[0]
    gls_c3 = torch.where(buoy2_a > 0.0, m.gls_c3m,
                         torch.full_like(buoy2_a, m.gls_c3p))
    Kprod = shear2 * akv_ex - buoy2_a * akt_ex
    Pprod = m.gls_c1 * shear2 * akv_ex - gls_c3 * buoy2_a * akt_ex
    neg_K = Kprod < 0.0
    neg_P = Pprod < 0.0
    Kprod = torch.where(neg_K, Kprod + buoy2_a * akt_ex, Kprod)
    Pprod = torch.where(neg_P, Pprod + gls_c3 * buoy2_a * akt_ex, Pprod)
    Hz_w = 0.5 * (Hz[:-1] + Hz[1:])
    tke0s = torch.clamp(tke0, min=Kmin)
    tke_n = tke_n + dt * Hz_w * Kprod
    gls_n_ = gls_n_ + dt * Hz_w * Pprod * gls0 / tke0s

    # implicit dissipation + negative-production terms on the diagonal
    diss = gls0 ** (-gls_exp1) * cmu_fac2 * tke0 ** tke_exp2
    # k-kl (MY2.5: p=0, m=1, n=1) wall-proximity function
    # (gls_corstep.F:612-624, Lmy25 branch)
    if p_ == 0.0 and m_ == 1.0 and n_ == 1.0:
        Lsc = gls0 ** gls_exp1 * cmu_fac1 * tke0s ** (-tke_exp1)
        d_bot = torch.clamp(z_w[1:-1] - z_w[:1], min=_EPS)
        d_top = torch.clamp(z_w[-1:] - z_w[1:-1], min=_EPS)
        wall_fac = 1.0 + _GLS_E2 / (vonKar * vonKar) * (Lsc / d_bot) ** 2 \
            + 0.25 / (vonKar * vonKar) * (Lsc / d_top) ** 2
    else:
        wall_fac = 1.0
    zero = torch.zeros_like(buoy2_a)
    BCK_d = Hz_w * (1.0 + dt * diss
                    + dt * torch.where(neg_K, buoy2_a * akt_ex / tke0s,
                                       zero))
    BCP_d = Hz_w * (1.0 + dt * m.gls_c2 * wall_fac * diss
                    + dt * torch.where(neg_P,
                                       gls_c3 * buoy2_a * akt_ex / tke0s,
                                       zero))

    # vertical diffusion between interfaces (through layer k): FCK[k]
    # couples interior interfaces k and k+1 (reference FCK(i,k),
    # k=2..N-1, pairs (k-1, k))
    FCK = -0.5 * dt * (mix.Akk[1:-1] + mix.Akk[:-2])[1:] / Hz[1:-1]
    FCP = -0.5 * dt * (mix.Akp[1:-1] + mix.Akp[:-2])[1:] / Hz[1:-1]
    zK = torch.zeros_like(FCK[:1])
    lowK = torch.cat([zK, FCK], dim=0)
    upK = torch.cat([FCK, zK], dim=0)
    diagK = BCK_d - lowK - upK
    lowP = torch.cat([zK, FCP], dim=0)
    upP = torch.cat([FCP, zK], dim=0)
    diagP = BCP_d - lowP - upP

    # ---- boundary values (Dirichlet at surface/bottom interfaces) -------
    taus = _stress_mag(sustr, svstr, st.ip1(sustr), st.jp1(svstr))
    taub = _stress_mag(bustr, bvstr, st.ip1(bustr), st.jp1(bvstr))
    tke_sfc = torch.clamp(cmu_fac3 * taus, min=Kmin)
    tke_bot = torch.clamp(cmu_fac3 * taub, min=Kmin)
    gls_sfc = torch.clamp(gls_fac4 * tke_sfc ** m_
                          * (L_sft * Zos_min) ** n_, min=Pmin)
    gls_bot = torch.clamp(gls_fac4 * (vonKar * Zob_min) ** n_
                          * tke_bot ** m_, min=Pmin)

    # surface/bottom psi flux correction on the top/bottom interior rows
    # (gls_corstep.F:741-755)
    cff_t = 0.5 * (tke_sfc + tke_n[-1] / Hz_w[-1])
    gls_fluxt = dt * (cmu0 ** p_) * n_ * cff_t ** m_ * L_sft ** n_ * \
        (Zos_min + 0.5 * Hz[-1]) ** (n_ - 1.0) * \
        0.5 * (mix.Akp[-1] + mix.Akp[-2])
    cff_b = 0.5 * (tke_bot + tke_n[0] / Hz_w[0])
    gls_fluxb = dt * (cmu0 ** p_) * n_ * vonKar ** n_ * cff_b ** m_ * \
        (0.5 * Hz[0] + Zob_min) ** (n_ - 1.0) * \
        0.5 * (mix.Akp[0] + mix.Akp[1])

    gls_rhs = gls_n_.clone()
    gls_rhs[-1] = gls_rhs[-1] - gls_fluxt
    gls_rhs[0] = gls_rhs[0] - gls_fluxb
    tke_new_i = closure_solve(lowK, diagK, upK, tke_n, use_kernels)
    gls_new_i = closure_solve(lowP, diagP, upP, gls_rhs, use_kernels)

    tke_new_i = torch.clamp(tke_new_i, min=Kmin)
    gls_new_i = torch.clamp(gls_new_i, min=Pmin)

    # ---- Galperin limiter + length scale (gls_corstep.F:785-815) --------
    sqrtN = torch.sqrt(torch.clamp(buoy2_a, min=0.0)) + _EPS
    lim = gls_fac5 * tke_new_i ** tke_exp4 * sqrtN ** (-n_)
    if n_ >= 0.0:
        gls_new_i = torch.minimum(gls_new_i, lim)
    else:
        gls_new_i = torch.maximum(gls_new_i, lim)
    Ls_unlmt = torch.clamp(gls_new_i ** gls_exp1 * cmu_fac1
                           * tke_new_i ** (-tke_exp1), min=_EPS)
    Ls_lmt = torch.where(
        buoy2_a > 0.0,
        torch.minimum(Ls_unlmt,
                      torch.sqrt(0.56 * tke_new_i
                                 / (torch.clamp(buoy2_a, min=0.0) + _EPS))),
        Ls_unlmt)
    gls_new_i = torch.clamp(gls_fac4 * tke_new_i ** m_ * Ls_lmt ** n_,
                            min=Pmin)

    # ---- stability functions --------------------------------------------
    Gh = torch.clamp(-buoy2_a * Ls_lmt * Ls_lmt / (2.0 * tke_new_i),
                     max=_CA["Gh0"])
    Gh = torch.minimum(Gh, Gh - (Gh - _CA["Ghcri"]) ** 2
                       / (Gh + _CA["Gh0"] - 2.0 * _CA["Ghcri"]))
    Gh = torch.clamp(Gh, min=_GHMIN)

    if m.gls_stab == "canuto_a":
        C = _canuto_a_coeffs()
        Gm = (C["b0"] / gls_fac6 - C["b1"] * Gh
              + C["b3"] * gls_fac6 * Gh ** 2) / \
            (C["b2"] - C["b4"] * gls_fac6 * Gh)
        Gm = torch.minimum(Gm, shear2 * Ls_lmt * Ls_lmt / (2.0 * tke_new_i))
        cden = (C["b0"] - C["b1"] * gls_fac6 * Gh
                + C["b2"] * gls_fac6 * Gm
                + C["b3"] * gls_fac6 ** 2 * Gh ** 2
                - C["b4"] * gls_fac6 ** 2 * Gh * Gm
                + C["b5"] * gls_fac6 ** 2 * Gm * Gm)
        Sm = (C["s0"] - C["s1"] * gls_fac6 * Gh
              + C["s2"] * gls_fac6 * Gm) / cden
        Sh = (C["s4"] - C["s5"] * gls_fac6 * Gh
              + C["s6"] * gls_fac6 * Gm) / cden
        Sm = torch.clamp(Sm, min=0.0) * sqrt2 / cmu0 ** 3
        Sh = torch.clamp(Sh, min=0.0) * sqrt2 / cmu0 ** 3
    else:  # kantha_clayson
        MY = _MY
        Sh1 = MY["A2"] * (1.0 - 6.0 * MY["A1"] / MY["B1"])
        Sh2 = 3.0 * MY["A2"] * (6.0 * MY["A1"]
                                + MY["B2"] * (1.0 - MY["C3"]))
        Sm2 = 9.0 * MY["A1"] * MY["A2"]
        Sm4 = 18.0 * MY["A1"] ** 2 + 9.0 * MY["A1"] * MY["A2"] \
            * (1.0 - MY["C2"])
        B1pm1o3 = MY["B1"] ** (-1.0 / 3.0)
        Sh = Sh1 / (1.0 - Sh2 * Gh)
        Sm = (B1pm1o3 + Sm4 * Sh * Gh) / (1.0 - Sm2 * Gh)

    ql = sqrt2 * 0.5 * (Ls_lmt * torch.sqrt(tke_new_i)
                        + mix.Lscale[1:-1] * torch.sqrt(tke0s))
    Akv_i_new = m.akv_bak + Sm * ql
    Akt_i_new = Sh * ql
    Akk_i_new = m.akk_bak + Sm * ql / m.gls_sigk
    Akp_i_new = m.akp_bak + Sm * ql / m.gls_sigp

    # surface/bottom coefficients
    Akv_sfc = m.akv_bak + L_sft * Zos_min * cmu0 * torch.sqrt(tke_sfc)
    Akv_bot = m.akv_bak + vonKar * Zob_min * cmu0 * torch.sqrt(tke_bot)

    def const(val):
        return torch.full_like(tke_bot, val)

    return MixState(
        tke=_bc_w(cfg, _assemble(tke_new_i, tke_bot, tke_sfc)),
        tke_prev=mix.tke,
        gls=_bc_w(cfg, _assemble(gls_new_i, gls_bot, gls_sfc)),
        gls_prev=mix.gls,
        Akv=_bc_w(cfg, _assemble(Akv_i_new, Akv_bot, Akv_sfc)),
        Akt=_bc_w(cfg, torch.stack([
            _assemble(m.akt_bak[it] + Akt_i_new, const(m.akt_bak[it]),
                      const(m.akt_bak[it])) for it in range(NAT)])),
        Akk=_bc_w(cfg, _assemble(Akk_i_new,
                                 m.akk_bak + Akv_bot / m.gls_sigk,
                                 m.akk_bak + Akv_sfc / m.gls_sigk)),
        Akp=_bc_w(cfg, _assemble(Akp_i_new,
                                 m.akp_bak + Akv_bot / m.gls_sigp,
                                 m.akp_bak + Akv_sfc / m.gls_sigp)),
        Lscale=_assemble(Ls_lmt, const(1.0e-6), const(1.0e-6)))


def my25_mixing_config(base=None):
    """Mellor-Yamada level-2.5 closure expressed through GLS: the k-kl
    member (p, m, n) = (0, 1, 1) with cmu0 = B1**(-1/3), Kantha-Clayson
    stability functions and the E2 wall-proximity function (Umlauf &
    Burchard 2003, Table 1).  A MixingConfig preset for `vmix='gls'`."""
    base = base or MixingConfig()
    return dataclasses.replace(
        base, vmix="gls",
        gls_p=0.0, gls_m=1.0, gls_n=1.0,
        gls_cmu0=0.5544,
        gls_c1=0.9, gls_c2=0.52, gls_c3m=2.5, gls_c3p=1.0,
        gls_sigk=1.96, gls_sigp=1.96,
        gls_kmin=5.0e-6, gls_pmin=5.0e-6,
        gls_stab="kantha_clayson")
