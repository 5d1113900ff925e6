"""Large, McWilliams & Doney (1994) K-profile parameterization (port of
roms_tpu/core/lmd.py; lmd_vmix.F, lmd_skpp.F, lmd_bkpp.F, lmd_swfrac.F).

Two routes, as in roms_tpu's step.  Inside the column kernel's class
(LMD-KPP without LMD_BKPP or LMD_DDMIX, ops/kpp.py and ops/prep.py) the
closure is kernel 15, whose plain version transliterates roms_tpu's
in-kernel block math.  Outside it, the step takes the whole-array
routines of this module, roms_tpu's jnp route: interior Ri, wave and
convective mixing (`lmd_vmix_interior`), double diffusion
(`lmd_ddmix`), the surface boundary layer (`lmd_skpp`) and the bottom
one (`lmd_bkpp`), each in roms_tpu's association.  Their parabolic
spline derivatives (`spline_ddz`, eight solves a step with LMD_BKPP) go
through kernel 17 where its class covers the system, the closures'
call-site gate (core/gls.py `closure_solve`).

The module also holds what the column kernel and the solar source
share: the LMD constants, the Jerlov shortwave fraction, the turbulent
velocity scales and the surface expansion coefficients.
"""

from __future__ import annotations

import math

import torch

from .. import constants
from ..config import ModelConfig
from ..ops import stencil as st
from .gls import closure_solve

# mod_scalars.F:1635-1712
LMD_RI0 = 0.7
LMD_BVFCON = -2.0e-5
LMD_NU0C = 0.01
LMD_NU0M = 10.0e-4
LMD_NU0S = 10.0e-4
LMD_CV = 1.25
LMD_RIC = 0.3
LMD_AM = 1.257
LMD_AS = -28.86
LMD_BETAT = -0.2
LMD_CEKMAN = 0.7
LMD_CMONOB = 1.0
LMD_CM = 8.36
LMD_CS = 98.96
LMD_EPSILON = 0.1
LMD_ZETAM = -0.2
LMD_ZETAS = -1.0
LMD_CSTAR = 10.0

# Jerlov water types (mod_scalars.F:1585-1595)
_MU1 = (0.35, 0.6, 1.0, 1.5, 1.4, 0.42, 0.37, 0.33, 0.00468592)
_MU2 = (23.0, 20.0, 17.0, 14.0, 7.9, 5.13, 3.54, 2.34, 1.51)
_R1 = (0.58, 0.62, 0.67, 0.77, 0.78, 0.57, 0.57, 0.57, 0.55)

_EPS = 1.0e-10
_SMALL = 1.0e-20

# double-diffusion constants (mod_scalars.F lmd_* defaults)
LMD_RRHO0 = 1.9
LMD_NUF = 0.001
LMD_FDD = 0.7
LMD_NU = 1.5e-6
LMD_TDD1 = 0.909
LMD_TDD2 = 4.6
LMD_TDD3 = 0.54
LMD_SDD1 = 0.15
LMD_SDD2 = 1.85
LMD_SDD3 = 0.85


def jerlov(jwtype: int):
    """(r1, 1/mu1, 1/mu2) of Jerlov water type `jwtype`."""
    i = jwtype - 1
    return _R1[i], 1.0 / _MU1[i], 1.0 / _MU2[i]


def swdk_frac(depth, jwtype: int = 1):
    """Fraction of shortwave remaining at positive depth below the
    surface (lmd_swfrac.F, Zscale=-1).  The e-folding depths enter as
    reciprocals, so the CUDA kernels and PyTorch on either device round
    alike (a CUDA tensor / scalar division is a product with the
    reciprocal, a CPU one a true division)."""
    r1, o_mu1, o_mu2 = jerlov(jwtype)
    return r1 * torch.exp(-depth * o_mu1) + \
        (1.0 - r1) * torch.exp(-depth * o_mu2)


def _wscale(Ustar, zetahat, vonKar):
    """Turbulent velocity scales wm/ws from similarity (lmd_skpp.F):
    x**0.25 and x**(1/3) as `pow`, roms_tpu's default (ops/fastmath.py
    is off unless ROMS_TPU_FASTMATH=1)."""
    Ustar3 = Ustar * Ustar * Ustar
    zetapar = zetahat / (Ustar3 + _SMALL)
    wm_stab = vonKar * Ustar / (1.0 + 5.0 * zetapar)
    one16 = torch.clamp(1.0 - 16.0 * zetapar, min=0.0)
    wm_uns = torch.where(
        zetapar > LMD_ZETAM,
        vonKar * Ustar * one16 ** 0.25,
        vonKar * torch.clamp(LMD_AM * Ustar3 - LMD_CM * zetahat,
                             min=0.0) ** (1.0 / 3.0))
    ws_uns = torch.where(
        zetapar > LMD_ZETAS,
        vonKar * Ustar * torch.sqrt(one16),
        vonKar * torch.clamp(LMD_AS * Ustar3 - LMD_CS * zetahat,
                             min=0.0) ** (1.0 / 3.0))
    stable = zetahat >= 0.0
    wm = torch.where(stable, wm_stab, wm_uns)
    ws = torch.where(stable, wm_stab, ws_uns)
    return wm, ws


def _alpha_beta(cfg: ModelConfig, t):
    """Surface thermal expansion / saline contraction (rho_eos.F:455-470,
    770-780).  Linear EOS: |Tcoef|, |Scoef|.  JM95: -(1/den) d(den)/dT
    and (1/den) d(den)/dS of the surface density den = den1 (z = 0).
    roms_tpu differentiates den with jax.jvp; here the derivatives of the
    polynomial are written out, which agrees to ~1e-13 and costs the
    host a few dozen tensor operations where torch.func.jvp's trace cost
    hundreds a step."""
    Ts = t[0][-1]
    if cfg.eos.linear:
        return (torch.full_like(Ts, abs(cfg.eos.Tcoef)),
                torch.full_like(Ts, abs(cfg.eos.Scoef)))
    from .rho_eos import _Q as Q, _jm95_parts, rho_eos_jm95
    ts = t[:, -1:]
    den = rho_eos_jm95(cfg, ts, torch.zeros_like(ts[0]))[0] + 1000.0
    T, S, sqrtS, *_ = _jm95_parts(cfg, ts)
    T, S, sqrtS = T[0], S[0], sqrtS[0]
    dden_dT = (Q["Q01"] + T * (2.0 * Q["Q02"] + T * (3.0 * Q["Q03"]
               + T * (4.0 * Q["Q04"] + T * (5.0 * Q["Q05"]))))
               + S * (Q["U01"] + T * (2.0 * Q["U02"] + T * (3.0 * Q["U03"]
                      + T * (4.0 * Q["U04"]))))
               + S * sqrtS * (Q["V01"] + T * (2.0 * Q["V02"])))
    dden_dS = ((Q["U00"] + T * (Q["U01"] + T * (Q["U02"] + T * (Q["U03"]
                + T * Q["U04"]))))
               + 1.5 * sqrtS * (Q["V00"] + T * (Q["V01"] + T * Q["V02"]))
               + 2.0 * Q["W00"] * S)
    # the clamps T >= -2, S >= 0 of the polynomial stop the derivative
    dden_dT = torch.where(Ts > -2.0, dden_dT, 0.0)
    if cfg.NT > 1:
        dden_dS = torch.where(t[1][-1] > 0.0, dden_dS, 0.0)
    return -dden_dT / den, dden_dS / den


def spline_ddz(rhs, Hz, use_kernels: bool = True):
    """Conservative parabolic-spline vertical derivative at interior
    interfaces 1..N-1 (the shared sweep of gls_corstep.F:278-310 and
    lmd_skpp.F RI_SPLINES):

        Hz[k] x[k-1] + 2(Hz[k]+Hz[k+1]) x[k] + Hz[k+1] x[k+1] = rhs[k]

    rhs: (N-1, ...).  The zero end rows (lower[0], upper[-1]) are the
    ones the solve ignores.  Kernel 17 where its class covers the
    system (core/gls.py `closure_solve`), else the plain sweep."""
    lo = Hz[1:-1]
    dg = 2.0 * (Hz[:-1] + Hz[1:])
    z = torch.zeros_like(lo[:1])
    return closure_solve(torch.cat([z, lo], dim=0), dg,
                         torch.cat([lo, z], dim=0), rhs, use_kernels)


def _shear_rhs(u, v):
    """3 x the level-to-level jumps of u and v summed over each rho
    point's two faces (the right-hand sides of the shear splines)."""
    du_c = (u[1:] - u[:-1]) + (st.ip1(u)[1:] - st.ip1(u)[:-1])
    dv_c = (v[1:] - v[:-1]) + (st.jp1(v)[1:] - st.jp1(v)[:-1])
    return 3.0 * du_c, 3.0 * dv_c


def lmd_vmix_interior(cfg: ModelConfig, u, v, bvf, Hz,
                      use_kernels: bool = True):
    """Interior mixing: shear instability, internal waves and convective
    adjustment (lmd_vmix.F:99-380 and lmd_finish).  Returns (Akv, Akt)
    at interfaces (N+1, ...) and (NAT, N+1, ...)."""
    ru, rv = _shear_rhs(u, v)
    dU = spline_ddz(ru, Hz, use_kernels)
    dV = spline_ddz(rv, Hz, use_kernels)
    shear2 = dU * dU + dV * dV
    bvf_i = bvf[1:-1]
    Rig = bvf_i / (shear2 + _EPS)

    # shear instability (LMD_RIMIX and the RI_SPLINES smoothing factor)
    cff = torch.clamp(torch.clamp(Rig, min=0.0) / LMD_RI0, max=1.0)
    nu_sx = (1.0 - cff * cff) ** 3
    sh = bvf_i / (Rig + _EPS)
    nu_sx = nu_sx * sh * sh / (sh * sh + 16.0e-10)

    # internal-wave background scaled by the stratification
    cffN = 1.0 / torch.sqrt(torch.clamp(bvf_i, min=1.0e-7))
    Akv_i = 1.0e-6 * cffN + LMD_NU0M * nu_sx
    Akt_i = 1.0e-7 * cffN + LMD_NU0S * nu_sx

    # convective adjustment (lmd_finish, LMD_CONVEC)
    cffc = torch.clamp(bvf_i, min=LMD_BVFCON)
    cffc = torch.clamp((LMD_BVFCON - cffc) / LMD_BVFCON, max=1.0)
    nu_sxc = (1.0 - cffc * cffc) ** 3
    Akv_i = Akv_i + LMD_NU0C * nu_sxc
    Akt_i = Akt_i + LMD_NU0C * nu_sxc

    zk = torch.full_like(Akv_i[:1], cfg.mixing.akv_bak)
    zt = torch.full_like(Akt_i[:1], cfg.mixing.akt_bak[0])
    Akv = torch.cat([zk, Akv_i, zk], dim=0)
    Akt1 = torch.cat([zt, Akt_i, zt], dim=0)
    return Akv, torch.stack([Akt1] * cfg.NAT)


def lmd_ddmix(cfg: ModelConfig, t, alfaobeta, Akt):
    """Double-diffusive interior mixing (LMD_DDMIX, lmd_vmix.F:363-429):
    the salt-fingering and diffusive-convection increments added to the
    temperature and salinity Akt.  alfaobeta: alpha/beta at the interior
    W interfaces (N-1, Mj, Li), core/rho_eos.py `eos_alpha_beta` with
    all_levels=True."""
    T, S = t[0], t[1]
    dT = T[1:] - T[:-1]
    dS_raw = S[1:] - S[:-1]
    sgn = torch.where(dS_raw >= 0.0, 1.0, -1.0)      # SIGN(1,0) = +1
    dS = sgn * torch.clamp(torch.abs(dS_raw), min=1.0e-14)
    Rrho = alfaobeta * dT / dS

    # salt fingering: Rrho in (1, Rrho0], dS > 0 (:380-393)
    finger = (Rrho > 1.0) & (dS > 0.0)
    Rf = torch.clamp(Rrho, max=LMD_RRHO0)
    nu1 = 1.0 - ((Rf - 1.0) / (LMD_RRHO0 - 1.0)) ** 2
    nu_dds_f = LMD_NUF * nu1 * nu1 * nu1
    nu_ddt_f = LMD_FDD * nu_dds_f

    # diffusive convection: 0 < Rrho < 1, dS < 0 (Marmorino & Caldwell
    # 1976; :397-415); the branch not taken sees Rrho = 0.7
    convec = (Rrho > 0.0) & (Rrho < 1.0) & (dS < 0.0)
    Rc = torch.where(convec, Rrho, 0.7)
    nu_ddt_c = LMD_NU * LMD_TDD1 * torch.exp(
        LMD_TDD2 * torch.exp(-LMD_TDD3 * ((1.0 / Rc) - 1.0)))
    nu_dds_c = torch.where(Rc < 0.5, nu_ddt_c * LMD_SDD1 * Rc,
                           nu_ddt_c * (LMD_SDD2 * Rc - LMD_SDD3))

    zero = torch.zeros_like(Rrho)
    nu_ddt = torch.where(finger, nu_ddt_f, torch.where(convec, nu_ddt_c,
                                                       zero))
    nu_dds = torch.where(finger, nu_dds_f, torch.where(convec, nu_dds_c,
                                                       zero))
    z = torch.zeros_like(nu_ddt[:1])
    add = [torch.cat([z, nu_ddt, z], dim=0)]
    if cfg.NAT > 1:
        add.append(torch.cat([z, nu_dds, z], dim=0))
    return torch.stack([Akt[it] + add[it] if it < len(add) else Akt[it]
                        for it in range(Akt.shape[0])])


def _gather_k(f, idx):
    """f[idx[j, i], j, i]: take_along_axis on the level axis."""
    return torch.gather(f, 0, idx[None]).squeeze(0)


def _spline_profiles(cfg, u, v, pden, Hz, use_kernels):
    """The spline derivatives of pden, u and v at all interfaces (zero at
    the bottom and the surface) and u, v at rho points."""
    ru, rv = _shear_rhs(u, v)
    dR_i = spline_ddz(6.0 * (pden[1:] - pden[:-1]), Hz, use_kernels)
    dU_i = spline_ddz(ru, Hz, use_kernels)
    dV_i = spline_ddz(rv, Hz, use_kernels)
    zz = torch.zeros_like(dR_i[:1])
    dR = torch.cat([zz, dR_i, zz], dim=0)            # (N+1, ...)
    dU = torch.cat([zz, dU_i, zz], dim=0)
    dV = torch.cat([zz, dV_i, zz], dim=0)
    u_r = 0.5 * (u + st.ip1(u))
    v_r = 0.5 * (v + st.jp1(v))
    return dR, dU, dV, u_r, v_r


def _vtc():
    vonKar = constants.vonKar
    return LMD_CV * math.sqrt(-LMD_BETAT) / \
        (math.sqrt(LMD_CS * LMD_EPSILON) * LMD_RIC * vonKar ** 2)


def lmd_skpp(cfg: ModelConfig, grid, t, u, v, pden, bvf, Hz, z_r, z_w,
             forcing, Akv, Akt, jwtype=None, use_kernels: bool = True):
    """Surface boundary layer (lmd_skpp.F) over whole arrays, in
    roms_tpu's jnp association (roms_tpu/core/lmd.py lmd_skpp, not the
    column kernel's).  Returns (Akv, Akt, ghats, hsbl); ghats (NAT, N+1,
    ...) is the nonlocal transport term of pre_step3d (LMD_NONLOCAL:
    vertical flux -= dt*Akt*ghats)."""
    if jwtype is None:
        jwtype = cfg.mixing.jwtype
    g = constants.g
    vonKar = constants.vonKar
    N = cfg.N
    NAT = cfg.NAT
    gorho0 = g / cfg.rho0
    Vtc = _vtc()
    lmd_Cg = LMD_CSTAR * vonKar * \
        (LMD_CS * vonKar * LMD_EPSILON) ** (1.0 / 3.0)

    sustr, svstr = forcing.sustr, forcing.svstr
    stflx, srflx = forcing.stflx, forcing.srflx
    taux_r = 0.5 * (sustr + st.ip1(sustr))
    tauy_r = 0.5 * (svstr + st.jp1(svstr))
    Ustar = (taux_r ** 2 + tauy_r ** 2) ** 0.25

    alpha, beta = _alpha_beta(cfg, t)
    if cfg.NT > 1:
        Bo = g * (alpha * (stflx[0] - srflx) - beta * stflx[1])
    else:
        Bo = g * alpha * (stflx[0] - srflx)
    Bosol = g * alpha * srflx

    # surface buoyancy flux absorbed above each interface (N+1 levels)
    depth_w = z_w[-1][None] - z_w
    swdk_w = swdk_frac(depth_w, jwtype)
    Bflux = Bo[None] + Bosol[None] * (1.0 - swdk_w)

    dR, dU, dV, u_r, v_r = _spline_profiles(cfg, u, v, pden, Hz,
                                            use_kernels)
    c3, c6 = 1.0 / 3.0, 1.0 / 6.0
    Rref = pden[-1] + Hz[-1] * (c3 * dR[-1] + c6 * dR[-2])
    Uref = u_r[-1] + Hz[-1] * (c3 * dU[-1] + c6 * dU[-2])
    Vref = v_r[-1] + Hz[-1] * (c3 * dV[-1] + c6 * dV[-2])

    # bulk Richardson number at interfaces 0..N-1 (depth(k) = z_w[N] -
    # z_w[k-1] of layer k); FC[N] = 0
    depth_k = z_w[-1][None] - z_w[:-1]
    Bf_k = Bflux[:-1]
    sigma = torch.where(Bf_k < 0.0,
                        torch.minimum(LMD_EPSILON * depth_k, depth_k),
                        depth_k)
    wm_k, ws_k = _wscale(Ustar[None], vonKar * sigma * Bf_k, vonKar)
    Rk = pden - Hz * (c3 * dR[:-1] + c6 * dR[1:])
    Uk = u_r - Hz * (c3 * dU[:-1] + c6 * dU[1:])
    Vk = v_r - Hz * (c3 * dV[:-1] + c6 * dV[1:])
    Ritop = -gorho0 * (Rref[None] - Rk) * depth_k
    Ribot = (Uref[None] - Uk) ** 2 + (Vref[None] - Vk) ** 2 + \
        Vtc * depth_k * ws_k * torch.sqrt(torch.abs(bvf[:-1]))
    FC = Ritop / (Ribot + _EPS)
    FCfull = torch.cat([FC, torch.zeros_like(FC[:1])], dim=0)

    # the first crossing scanning down: the largest k in [2..N] with
    # FC[k] < Ric <= FC[k-1]; none: ksbl = 1, hsbl = z_w[1]
    karr = torch.arange(1, N + 1, device=z_w.device)[:, None, None]
    cond = (FCfull[1:] < LMD_RIC) & (FCfull[:-1] >= LMD_RIC) & (karr >= 2)
    kcross = torch.where(cond, karr, 0).amax(dim=0)
    found = kcross >= 2
    ks = torch.clamp(kcross, min=1)

    FCk = _gather_k(FCfull, ks)
    FCkm1 = _gather_k(FCfull, ks - 1)
    zwk = _gather_k(z_w, ks)
    zwkm1 = _gather_k(z_w, ks - 1)
    hsbl_x = ((FCkm1 - LMD_RIC) * zwk + (LMD_RIC - FCk) * zwkm1) / \
        (FCkm1 - FCk + _SMALL)
    hsbl = torch.where(found, hsbl_x, z_w[1])

    # the Ekman and Monin-Obukhov caps under stable forcing
    swdk_bl = swdk_frac(z_w[-1] - hsbl, jwtype)
    Bfsfc = Bo + Bosol * (1.0 - swdk_bl)
    hekman = LMD_CEKMAN * Ustar / torch.clamp(torch.abs(grid.f), min=_EPS)
    hmonob = LMD_CMONOB * Ustar ** 3 / \
        torch.clamp(vonKar * Bfsfc, min=_EPS)
    cap = z_w[-1] - torch.minimum(torch.minimum(hekman, hmonob),
                                  z_w[-1] - hsbl)
    hsbl = torch.where((Ustar > 0.0) & (Bfsfc > 0.0), cap, hsbl)
    hsbl = torch.minimum(torch.maximum(hsbl, z_w[0]), z_w[-1])

    ksbl = surface_ksbl(z_w, hsbl)

    # boundary-layer thickness scales and matching
    swdk_bl = swdk_frac(z_w[-1] - hsbl, jwtype)
    Bfsfc = Bo + Bosol * (1.0 - swdk_bl)
    zbl = z_w[-1] - hsbl
    sl_dpth = LMD_EPSILON * zbl
    sig_bl = torch.where(Bfsfc > 0.0, zbl, LMD_EPSILON * zbl)
    wm_bl, ws_bl = _wscale(Ustar, vonKar * sig_bl * Bfsfc, vonKar)
    f1 = 5.0 * torch.clamp(Bfsfc, min=0.0) * vonKar / (Ustar ** 4 + _EPS)

    zw_ks = _gather_k(z_w, ksbl)
    zw_ksm1 = _gather_k(z_w, ksbl - 1)
    cffk = 1.0 / (zw_ks - zw_ksm1)
    cff_dn = cffk * (hsbl - zw_ksm1)
    cff_up = cffk * (zw_ks - hsbl)

    def match(K):
        K_bl = cff_dn * _gather_k(K, ksbl) + cff_up * _gather_k(K, ksbl - 1)
        dK_bl = cffk * (_gather_k(K, ksbl) - _gather_k(K, ksbl - 1))
        return K_bl, dK_bl

    Kv_bl, dKv_bl = match(Akv)
    Kv1 = Kv_bl / (zbl * wm_bl + _EPS)
    dKv1 = torch.clamp(-dKv_bl / (wm_bl + _EPS) - Kv_bl * f1, max=0.0)
    Kt_bls = [match(Akt[it]) for it in range(NAT)]
    Kt1 = [Kt_bls[it][0] / (zbl * ws_bl + _EPS) for it in range(NAT)]
    dKt1 = [torch.clamp(-Kt_bls[it][1] / (ws_bl + _EPS)
                        - Kt_bls[it][0] * f1, max=0.0)
            for it in range(NAT)]

    # the shape-function profile at interfaces k = 1..N-1 above ksbl
    kif = torch.arange(1, N, device=z_w.device)[:, None, None]
    inside = kif > ksbl[None]
    depth_i = z_w[-1][None] - z_w[1:-1]
    Bf_i = Bflux[1:-1]
    sigma_i = torch.where(Bf_i < 0.0,
                          torch.minimum(sl_dpth[None], depth_i), depth_i)
    wm_i, ws_i = _wscale(Ustar[None], vonKar * sigma_i * Bf_i, vonKar)
    sig = depth_i / (zbl[None] + _EPS)
    a1 = sig - 2.0
    a2 = 3.0 - 2.0 * sig
    a3 = sig - 1.0
    Gm = a1 + a2 * Kv1[None] + a3 * dKv1[None]
    Akv_bl = depth_i * wm_i * (1.0 + sig * Gm)
    Akv_new = torch.cat([Akv[:1], torch.where(inside, Akv_bl, Akv[1:-1]),
                         Akv[-1:]], dim=0)

    Akt_new = []
    for it in range(NAT):
        Gt = a1 + a2 * Kt1[it][None] + a3 * dKt1[it][None]
        Akt_bl = depth_i * ws_i * (1.0 + sig * Gt)
        Akt_new.append(torch.cat([
            Akt[it][:1], torch.where(inside, Akt_bl, Akt[it][1:-1]),
            Akt[it][-1:]], dim=0))
    Akt_new = torch.stack(Akt_new)

    # nonlocal transport (LMD_NONLOCAL): Cg * the surface flux / (zbl
    # ws) under unstable forcing, inside the boundary layer only
    unstable = Bflux[1:-1] < 0.0
    cff_nl = lmd_Cg / (zbl[None] * ws_i + _EPS)
    zero = torch.zeros_like(depth_i)
    ghat_T = torch.where(inside & unstable,
                         -cff_nl * (stflx[0][None] - srflx[None]
                                    + srflx[None] * (1.0 - swdk_w[1:-1])),
                         zero)
    pads = torch.zeros_like(ghat_T[:1])
    ghats = [torch.cat([pads, ghat_T, pads], dim=0)]
    if NAT > 1:
        ghat_S = torch.where(inside & unstable, cff_nl * stflx[1][None],
                             zero)
        ghats.append(torch.cat([pads, ghat_S, pads], dim=0))
    return Akv_new, Akt_new, torch.stack(ghats), hsbl


def surface_ksbl(z_w, hsbl):
    """The number of interfaces z_w[0..N-1] strictly below hsbl, at
    least 1: the surface layer's level, and LMD_BKPP's guard."""
    return torch.clamp((z_w[:-1] < hsbl[None]).sum(dim=0), min=1)


def lmd_bkpp(cfg: ModelConfig, grid, t, u, v, pden, bvf, Hz, z_r, z_w,
             forcing, bustr, bvstr, Akv, Akt, ksbl_guard=None, jwtype=None,
             use_kernels: bool = True):
    """Bottom boundary layer KPP (lmd_bkpp.F): lmd_skpp's mirror with
    depth measured up from the bottom and the bottom-stress friction
    velocity.  Inside the surface boundary layer (k > ksbl_guard) the
    bottom profile only raises the coefficients, elsewhere in the bottom
    layer it replaces them (lmd_bkpp.F:536-552).  Returns (Akv, Akt,
    hbbl)."""
    if jwtype is None:
        jwtype = cfg.mixing.jwtype
    g = constants.g
    vonKar = constants.vonKar
    N = cfg.N
    NAT = cfg.NAT
    gorho0 = g / cfg.rho0
    Vtc = _vtc()

    taux_r = 0.5 * (bustr + st.ip1(bustr))
    tauy_r = 0.5 * (bvstr + st.jp1(bvstr))
    Ustar = (taux_r ** 2 + tauy_r ** 2) ** 0.25

    alpha, beta = _alpha_beta(cfg, t)
    btflx = forcing.btflx
    if cfg.NT > 1:
        Bo = g * (alpha * btflx[0] - beta * btflx[1])
    else:
        Bo = g * alpha * btflx[0]
    Bosol = g * alpha * forcing.srflx
    depth_sfc = z_w[-1][None] - z_w
    Bflux = Bo[None] + Bosol[None] * (1.0 - swdk_frac(depth_sfc, jwtype))

    dR, dU, dV, u_r, v_r = _spline_profiles(cfg, u, v, pden, Hz,
                                            use_kernels)
    c3, c6 = 1.0 / 3.0, 1.0 / 6.0
    # bottom reference values (lmd_bkpp.F:268-276)
    Rref = pden[0] - Hz[0] * (c3 * dR[0] + c6 * dR[1])
    Uref = u_r[0] - Hz[0] * (c3 * dU[0] + c6 * dU[1])
    Vref = v_r[0] - Hz[0] * (c3 * dV[0] + c6 * dV[1])

    # bulk Richardson number at interfaces 1..N, depth up from the bottom
    depth_k = z_w[1:] - z_w[:1]
    Bf_k = Bflux[1:]
    sigma = torch.where(Bf_k < 0.0,
                        torch.minimum(LMD_EPSILON * depth_k, depth_k),
                        depth_k)
    wm_k, ws_k = _wscale(Ustar[None], vonKar * sigma * Bf_k, vonKar)
    Rk = pden + Hz * (c3 * dR[1:] + c6 * dR[:-1])
    Uk = u_r + Hz * (c3 * dU[1:] + c6 * dU[:-1])
    Vk = v_r + Hz * (c3 * dV[1:] + c6 * dV[:-1])
    Ritop = -gorho0 * (Rk - Rref[None]) * depth_k
    Ribot = (Uk - Uref[None]) ** 2 + (Vk - Vref[None]) ** 2 + \
        Vtc * depth_k * ws_k * torch.sqrt(torch.abs(bvf[1:]))
    FC = Ritop / (Ribot + _EPS)                      # interfaces 1..N
    FCfull = torch.cat([torch.zeros_like(FC[:1]), FC], dim=0)

    # the first crossing scanning up: the smallest k with
    # FC[k-1] < Ric <= FC[k]
    karr = torch.arange(1, N + 1, device=z_w.device)[:, None, None]
    cond = (FCfull[:-1] < LMD_RIC) & (FCfull[1:] >= LMD_RIC)
    kcross = torch.where(cond, karr, N + 1).amin(dim=0)
    found = kcross <= N
    kb = torch.clamp(kcross, max=N)

    FCk = _gather_k(FCfull, kb)
    FCkm1 = _gather_k(FCfull, kb - 1)
    zwk = _gather_k(z_w, kb)
    zwkm1 = _gather_k(z_w, kb - 1)
    hbbl_x = ((LMD_RIC - FCkm1) * zwk + (FCk - LMD_RIC) * zwkm1) / \
        (FCk - FCkm1 + _SMALL)
    hbbl = torch.where(found, hbbl_x, z_w[-1])

    # the Ekman cap from the bottom (lmd_bkpp.F:365-371)
    hekman = LMD_CEKMAN * Ustar / torch.clamp(torch.abs(grid.f),
                                              min=_EPS) - grid.h
    hbbl = torch.minimum(hbbl, hekman)
    hbbl = torch.minimum(torch.maximum(hbbl, z_w[0]), z_w[-1])

    kbbl = torch.clamp(N - (z_w[1:] > hbbl[None]).sum(dim=0) + 1, min=1)
    kbbl = torch.clamp(kbbl, max=N)

    zbl = hbbl - z_w[0]
    bl_dpth = LMD_EPSILON * zbl
    swdk_bl = swdk_frac(z_w[-1] - hbbl, jwtype)
    Bfbot = Bo + Bosol * (1.0 - swdk_bl)
    sig_bl = torch.where(Bfbot > 0.0, zbl, LMD_EPSILON * zbl)
    wm_bl, ws_bl = _wscale(Ustar, vonKar * sig_bl * Bfbot, vonKar)
    f1 = 5.0 * torch.clamp(Bfbot, min=0.0) * vonKar / (Ustar ** 4 + _EPS)

    zw_kb = _gather_k(z_w, kbbl)
    zw_kbm1 = _gather_k(z_w, kbbl - 1)
    cffk = 1.0 / (zw_kb - zw_kbm1)
    cff_dn = cffk * (hbbl - zw_kbm1)
    cff_up = cffk * (zw_kb - hbbl)

    def match(K, w):
        K_bl = cff_dn * _gather_k(K, kbbl) + cff_up * _gather_k(K, kbbl - 1)
        dK_bl = -cffk * (_gather_k(K, kbbl) - _gather_k(K, kbbl - 1))
        G1 = K_bl / (zbl * w + _EPS)
        dG1 = torch.clamp(K_bl * f1 - dK_bl / (w + _EPS), max=0.0)
        return G1, dG1

    Gm1, dGm1 = match(Akv, wm_bl)
    Gt1s = [match(Akt[it], ws_bl) for it in range(NAT)]

    kif = torch.arange(1, N, device=z_w.device)[:, None, None]
    inside = z_w[1:-1] < hbbl[None]
    depth_i = z_w[1:-1] - z_w[:1]
    Bf_i = Bflux[1:-1]
    sigma_i = torch.where(Bf_i < 0.0,
                          torch.minimum(bl_dpth[None], depth_i), depth_i)
    wm_i, ws_i = _wscale(Ustar[None], vonKar * sigma_i * Bf_i, vonKar)
    sig = depth_i / (zbl[None] + _EPS)
    a1 = sig - 2.0
    a2 = 3.0 - 2.0 * sig
    a3 = sig - 1.0
    Gm = a1 + a2 * Gm1[None] + a3 * dGm1[None]
    Akv_bl = depth_i * wm_i * (1.0 + sig * Gm)
    # inside the surface boundary layer only raise; else replace
    in_sbl = (ksbl_guard[None] < kif) if ksbl_guard is not None \
        else torch.zeros_like(inside)
    newKv = torch.where(in_sbl, torch.maximum(Akv[1:-1], Akv_bl), Akv_bl)
    Akv_new = torch.cat([Akv[:1], torch.where(inside, newKv, Akv[1:-1]),
                         Akv[-1:]], dim=0)

    Akt_new = []
    for it in range(NAT):
        G1, dG1 = Gt1s[it]
        Gt = a1 + a2 * G1[None] + a3 * dG1[None]
        Akt_bl = depth_i * ws_i * (1.0 + sig * Gt)
        newKt = torch.where(in_sbl, torch.maximum(Akt[it][1:-1], Akt_bl),
                            Akt_bl)
        Akt_new.append(torch.cat([
            Akt[it][:1], torch.where(inside, newKt, Akt[it][1:-1]),
            Akt[it][-1:]], dim=0))
    return Akv_new, torch.stack(Akt_new), hbbl
