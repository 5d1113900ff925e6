"""Kernel 14: the LMD-KPP column closure (csrc/kpp.cu, KPP mode).

Replaces roms_tpu/ops/pallas_kpp.py `kpp_pallas` and its wrapper
`lmd_kpp_fused`: interior Richardson-number mixing, the surface boundary
layer (bulk Richardson depth, Ekman/Monin-Obukhov caps, shape functions)
and the nonlocal transport, one column at a time (lmd_vmix.F,
lmd_skpp.F).  The plain version `kpp_block` transliterates roms_tpu's
in-kernel block math (pallas_kpp.py:89-270): the three-RHS Thomas sweep,
the select-reduction gathers and the same kcross/ksbl scans, so its
threshold tests pick the levels the Pallas kernel picks.  It differs
from that block math only where PyTorch rounds a constant division
differently on CPU and CUDA: a tensor over a constant is written as a
product with the reciprocal, a constant over a tensor as a true
division, an integer power as products.

`covers` is the class of roms_tpu's KPP routes (core/stepping.py:296-
318): LMD mixing without the bottom boundary layer or double diffusion.
In that class the step takes the fused prep route (ops/prep.py);
roms_tpu takes this entry point instead only beside a BBL closure,
which the port does not run yet.
"""

from __future__ import annotations

import torch

from .. import constants
from ..core.lmd import (LMD_BETAT, LMD_BVFCON, LMD_CEKMAN, LMD_CMONOB,
                        LMD_CS, LMD_CSTAR, LMD_CV, LMD_EPSILON, LMD_NU0C,
                        LMD_NU0M, LMD_NU0S, LMD_RI0, LMD_RIC, _EPS, _SMALL,
                        _wscale, jerlov, swdk_frac)
from . import _lib
from . import stencil as st


def covers(cfg) -> bool:
    m = cfg.mixing
    return m.vmix == "lmd" and not m.bkpp and not m.ddmix


def kpp_params(cfg):
    """Static parameters of the column closure (pallas_kpp.py:311-312)
    with the derived constants, each computed once in float64."""
    vonKar = constants.vonKar
    r1, o_mu1, o_mu2 = jerlov(cfg.mixing.jwtype)
    return dict(
        N=cfg.N, akv_bak=cfg.mixing.akv_bak, akt_bak0=cfg.mixing.akt_bak[0],
        jwtype=cfg.mixing.jwtype, r1=r1, o_mu1=o_mu1, o_mu2=o_mu2,
        neg_gorho0=-(constants.g / cfg.rho0),
        Vtc=LMD_CV * (-LMD_BETAT) ** 0.5 /
        ((LMD_CS * LMD_EPSILON) ** 0.5 * LMD_RIC * vonKar ** 2),
        Cg=LMD_CSTAR * vonKar *
        (LMD_CS * vonKar * LMD_EPSILON) ** (1.0 / 3.0))


def _thomas_multi(lower, diag, upper, rhs_list):
    """Unrolled Thomas solve along axis 0 for several right-hand sides
    sharing one matrix (pallas_kpp.py:57-77)."""
    M = diag.shape[0]
    inv0 = 1.0 / diag[0]
    cp = [upper[0] * inv0]
    dps = [[r[0] * inv0] for r in rhs_list]
    for k in range(1, M):
        denom = 1.0 / (diag[k] - lower[k] * cp[k - 1])
        cp.append(upper[k] * denom)
        for dp, r in zip(dps, rhs_list):
            dp.append((r[k] - lower[k] * dp[k - 1]) * denom)
    outs = []
    for dp in dps:
        x = [None] * M
        x[M - 1] = dp[M - 1]
        for k in range(M - 2, -1, -1):
            x[k] = dp[k] - cp[k] * x[k + 1]
        outs.append(torch.stack(x))
    return outs


def _gather_k(F, idx):
    """F[idx] along axis 0 (pallas_kpp.py:80-86)."""
    return torch.gather(F, 0, idx[None])[0]


def kpp_block(p, u_r, v_r, pden, bvf, Hz, z_w,
              Ustar, Bo, Bosol, absf, flxT, flxS, srflx):
    """The KPP column physics over whole arrays ((levels, Mj, Li) and
    (Mj, Li)).  Returns (Akv, Akt_profile, ghT, ghS, hsbl)."""
    N = p["N"]
    vonKar = constants.vonKar

    # ---- shared spline derivatives (one factorization, 3 RHS) ----------
    zpad = torch.zeros_like(Hz[:1])
    lower = torch.cat([zpad, Hz[1:-1]], dim=0)
    upper = torch.cat([Hz[1:-1], zpad], dim=0)
    dg = 2.0 * (Hz[:-1] + Hz[1:])
    dR_i, dU_i, dV_i = _thomas_multi(
        lower, dg, upper,
        [6.0 * (pden[1:] - pden[:-1]),
         6.0 * (u_r[1:] - u_r[:-1]),
         6.0 * (v_r[1:] - v_r[:-1])])
    zz = torch.zeros_like(dR_i[:1])
    dR = torch.cat([zz, dR_i, zz], dim=0)      # (N+1, ...)
    dU = torch.cat([zz, dU_i, zz], dim=0)
    dV = torch.cat([zz, dV_i, zz], dim=0)

    # ---- interior mixing (lmd_vmix.F + lmd_finish) ----------------------
    shear2 = dU_i * dU_i + dV_i * dV_i
    bvf_i = bvf[1:-1]
    Rig = bvf_i / (shear2 + _EPS)
    cff = torch.clamp(torch.clamp(Rig, min=0.0) * (1.0 / LMD_RI0), max=1.0)
    nu_sx = 1.0 - cff * cff
    nu_sx = nu_sx * nu_sx * nu_sx
    sh = bvf_i / (Rig + _EPS)
    nu_sx = nu_sx * sh * sh / (sh * sh + 16.0e-10)
    cffN = 1.0 / torch.sqrt(torch.clamp(bvf_i, min=1.0e-7))
    Akv_i = 1.0e-6 * cffN + LMD_NU0M * nu_sx
    Akt_i = 1.0e-7 * cffN + LMD_NU0S * nu_sx
    cffc = torch.clamp(bvf_i, min=LMD_BVFCON)
    cffc = torch.clamp((LMD_BVFCON - cffc) * (1.0 / LMD_BVFCON), max=1.0)
    nu_sxc = 1.0 - cffc * cffc
    nu_sxc = nu_sxc * nu_sxc * nu_sxc
    Akv_i = Akv_i + LMD_NU0C * nu_sxc
    Akt_i = Akt_i + LMD_NU0C * nu_sxc
    zk = torch.full_like(Akv_i[:1], p["akv_bak"])
    zt = torch.full_like(Akt_i[:1], p["akt_bak0"])
    Akv = torch.cat([zk, Akv_i, zk], dim=0)
    Akt = torch.cat([zt, Akt_i, zt], dim=0)

    # ---- surface buoyancy flux at interfaces -----------------------------
    depth_w = z_w[N][None] - z_w
    swdk_w = swdk_frac(depth_w, p["jwtype"])
    Bflux = Bo[None] + Bosol[None] * (1.0 - swdk_w)

    # ---- bulk Richardson number (lmd_skpp.F) ----------------------------
    c3, c6 = 1.0 / 3.0, 1.0 / 6.0
    Rref = pden[N - 1] + Hz[N - 1] * (c3 * dR[N] + c6 * dR[N - 1])
    Uref = u_r[N - 1] + Hz[N - 1] * (c3 * dU[N] + c6 * dU[N - 1])
    Vref = v_r[N - 1] + Hz[N - 1] * (c3 * dV[N] + c6 * dV[N - 1])

    depth_k = z_w[N][None] - z_w[:-1]
    Bf_k = Bflux[:-1]
    sl_dpth0 = LMD_EPSILON * depth_k
    sigma = torch.where(Bf_k < 0.0, torch.minimum(sl_dpth0, depth_k),
                        depth_k)
    _, ws_k = _wscale(Ustar[None], vonKar * sigma * Bf_k, vonKar)

    Rk = pden - Hz * (c3 * dR[:-1] + c6 * dR[1:])
    Uk = u_r - Hz * (c3 * dU[:-1] + c6 * dU[1:])
    Vk = v_r - Hz * (c3 * dV[:-1] + c6 * dV[1:])
    Ritop = p["neg_gorho0"] * (Rref[None] - Rk) * depth_k
    dUr = Uref[None] - Uk
    dVr = Vref[None] - Vk
    Ribot = dUr * dUr + dVr * dVr + \
        p["Vtc"] * depth_k * ws_k * torch.sqrt(torch.abs(bvf[:-1]))
    FC = Ritop / (Ribot + _EPS)
    FCfull = torch.cat([FC, torch.zeros_like(FC[:1])], dim=0)

    # first crossing scanning: largest k in [2..N] with FC[k]<Ric<=FC[k-1]
    kcross = torch.zeros(Ustar.shape, dtype=torch.int64,
                         device=Ustar.device)
    for k in range(2, N + 1):
        cond = (FCfull[k] < LMD_RIC) & (FCfull[k - 1] >= LMD_RIC)
        kcross = torch.where(cond, k, kcross)
    found = kcross >= 2
    ks = torch.clamp(kcross, min=1)

    FCk = _gather_k(FCfull, ks)
    FCkm1 = _gather_k(FCfull, ks - 1)
    zwk = _gather_k(z_w, ks)
    zwkm1 = _gather_k(z_w, ks - 1)
    hsbl_x = ((FCkm1 - LMD_RIC) * zwk + (LMD_RIC - FCk) * zwkm1) / \
        (FCkm1 - FCk + _SMALL)
    hsbl = torch.where(found, hsbl_x, z_w[1])

    # ---- Ekman / Monin-Obukhov caps under stable forcing -----------------
    swdk_bl = swdk_frac(z_w[N] - hsbl, p["jwtype"])
    Bfsfc = Bo + Bosol * (1.0 - swdk_bl)
    hekman = LMD_CEKMAN * Ustar / torch.clamp(absf, min=_EPS)
    hmonob = LMD_CMONOB * (Ustar * Ustar * Ustar) / \
        torch.clamp(vonKar * Bfsfc, min=_EPS)
    cap = z_w[N] - torch.minimum(torch.minimum(hekman, hmonob),
                                 z_w[N] - hsbl)
    hsbl = torch.where((Ustar > 0.0) & (Bfsfc > 0.0), cap, hsbl)
    hsbl = torch.minimum(torch.maximum(hsbl, z_w[0]), z_w[N])

    # ksbl: number of interfaces z_w[0..N-1] strictly below hsbl
    ksbl = torch.sum((z_w[:-1] < hsbl[None]).to(torch.int64), dim=0)
    ksbl = torch.clamp(ksbl, min=1)

    # ---- boundary-layer scales and profile matching ----------------------
    swdk_bl = swdk_frac(z_w[N] - hsbl, p["jwtype"])
    Bfsfc = Bo + Bosol * (1.0 - swdk_bl)
    zbl = z_w[N] - hsbl
    sl_dpth = LMD_EPSILON * zbl
    sig_bl = torch.where(Bfsfc > 0.0, zbl, LMD_EPSILON * zbl)
    wm_bl, ws_bl = _wscale(Ustar, vonKar * sig_bl * Bfsfc, vonKar)
    U2 = Ustar * Ustar
    f1 = 5.0 * torch.clamp(Bfsfc, min=0.0) * vonKar / (U2 * U2 + _EPS)

    zw_ks = _gather_k(z_w, ksbl)
    zw_ksm1 = _gather_k(z_w, ksbl - 1)
    cffk = 1.0 / (zw_ks - zw_ksm1)
    cff_dn = cffk * (hsbl - zw_ksm1)
    cff_up = cffk * (zw_ks - hsbl)

    def match(K):
        K_at = _gather_k(K, ksbl)
        K_at1 = _gather_k(K, ksbl - 1)
        return cff_dn * K_at + cff_up * K_at1, cffk * (K_at - K_at1)

    Kv_bl, dKv_bl = match(Akv)
    Kv1 = Kv_bl / (zbl * wm_bl + _EPS)
    dKv1 = torch.clamp(-dKv_bl / (wm_bl + _EPS) - Kv_bl * f1, max=0.0)
    Kt_bl, dKt_bl = match(Akt)
    Kt1 = Kt_bl / (zbl * ws_bl + _EPS)
    dKt1 = torch.clamp(-dKt_bl / (ws_bl + _EPS) - Kt_bl * f1, max=0.0)

    # ---- interior overwrite with shape-function profile ------------------
    kif = torch.arange(1, N, device=Hz.device)[:, None, None]
    inside = kif > ksbl[None]
    depth_i = z_w[N][None] - z_w[1:-1]
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
    Akv_out = torch.cat(
        [Akv[:1], torch.where(inside, Akv_bl, Akv[1:-1]), Akv[-1:]], dim=0)
    Gt = a1 + a2 * Kt1[None] + a3 * dKt1[None]
    Akt_bl = depth_i * ws_i * (1.0 + sig * Gt)
    Akt_out = torch.cat(
        [Akt[:1], torch.where(inside, Akt_bl, Akt[1:-1]), Akt[-1:]], dim=0)

    # ---- nonlocal transport (LMD_NONLOCAL) -------------------------------
    nonlocal_ = inside & (Bf_i < 0.0)
    cff_nl = torch.full_like(ws_i, p["Cg"]) / (zbl[None] * ws_i + _EPS)
    zeros_i = torch.zeros_like(cff_nl)
    ghT_i = torch.where(
        nonlocal_,
        -cff_nl * (flxT[None] + srflx[None] * (1.0 - swdk_w[1:-1])),
        zeros_i)
    ghS_i = torch.where(nonlocal_, cff_nl * flxS[None], zeros_i)
    ghT = torch.cat([zz, ghT_i, zz], dim=0)
    ghS = torch.cat([zz, ghS_i, zz], dim=0)
    return Akv_out, Akt_out, ghT, ghS, hsbl


def surface_forcing(cfg, grid, t, u, v, forcing):
    """The 2-D inputs of the column closure and the rho-point
    velocities, computed outside the kernel as roms_tpu does
    (pallas_kpp.py:340-360): (u_r, v_r, Ustar, Bo, Bosol, |f|, flxT,
    flxS, srflx)."""
    from ..core.lmd import _alpha_beta
    g = constants.g
    taux_r = 0.5 * (forcing.sustr + st.ip1(forcing.sustr))
    tauy_r = 0.5 * (forcing.svstr + st.jp1(forcing.svstr))
    Ustar = (taux_r * taux_r + tauy_r * tauy_r) ** 0.25
    alpha, beta = _alpha_beta(cfg, t)
    stflx, srflx = forcing.stflx, forcing.srflx
    if cfg.NT > 1:
        Bo = g * (alpha * (stflx[0] - srflx) - beta * stflx[1])
        flxS = stflx[1]
    else:
        Bo = g * alpha * (stflx[0] - srflx)
        flxS = torch.zeros_like(srflx)
    Bosol = g * alpha * srflx
    u_r = 0.5 * (u + st.ip1(u))
    v_r = 0.5 * (v + st.jp1(v))
    return (u_r, v_r, Ustar, Bo, Bosol, torch.abs(grid.f),
            stflx[0] - srflx, flxS, srflx)


def stack_tracers(cfg, Akt_prof, ghT, ghS):
    """Akt over the NAT active tracers and ghats, as core/lmd.py
    returns them."""
    Akt = torch.stack([Akt_prof] * cfg.NAT)
    ghats = torch.stack([ghT, ghS]) if cfg.NAT > 1 else ghT[None]
    return Akt, ghats


def kpp_plain(cfg, u_r, v_r, pden, bvf, Hz, z_w, Ustar, Bo, Bosol, absf,
              flxT, flxS, srflx):
    """(Akv, Akt_profile, ghT, ghS, hsbl)."""
    return kpp_block(kpp_params(cfg), u_r, v_r, pden, bvf, Hz, z_w, Ustar,
                     Bo, Bosol, absf, flxT, flxS, srflx)


def kpp(cfg, u_r, v_r, pden, bvf, Hz, z_w, Ustar, Bo, Bosol, absf, flxT,
        flxS, srflx):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if u_r.device.type == "cpu":
        return kpp_plain(cfg, u_r, v_r, pden, bvf, Hz, z_w, Ustar, Bo,
                         Bosol, absf, flxT, flxS, srflx)
    cols = [u_r, v_r, pden, bvf, Hz, z_w]
    planes = [Ustar, Bo, Bosol, absf, flxT, flxS, srflx]
    return launch_column(cfg, "kpp", cols, planes)[0]


# threads a block of the column kernel by element size (csrc/kpp.cu; the
# float32 choice timed against other sizes by `chip_smoke.py --profile`,
# PERF.md)
PREP_THREADS = {4: 64, 8: 32}


def column_values(N: int) -> int:
    """Values a thread of the column kernel keeps in shared memory: the
    interior bvf (N-1), the Thomas cp (N-2) and the three spline
    derivatives (N-1 each)."""
    return 5 * N - 6


def prep_launch_shape(N: int, Mj: int, Li: int, itemsize: int):
    """The column kernel's (threads, blocks, dynamic shared memory bytes),
    one thread a column, in either mode; a thread's values lie B + 1
    apart (no bank conflict when a lane reads another's levels)."""
    B = PREP_THREADS[itemsize]
    return B, -(-(Mj * Li) // B), itemsize * column_values(N) * (B + 1)


def launch_column(cfg, name, cols, planes, t=None, z_r=None):
    """Launch csrc/kpp.cu in KPP mode (`t` is None; cols = u_r, v_r,
    pden, bvf, Hz, z_w) or in prep mode (cols = u_r, v_r, Hz, z_w, with
    t and z_r).  Returns (outputs, Akt, ghats): the outputs (Akv,
    Akt_profile, ghT, ghS, hsbl), preceded in prep mode by (rho, pden,
    rhoA, rhoS); in prep mode the kernel writes Akt over the NAT active
    tracers and ghats as `stack_tracers` stacks them, and Akt_profile,
    ghT and ghS are views of them (in KPP mode Akt and ghats are None).
    No PyTorch operation runs besides the allocations."""
    prep = t is not None
    ins, sfx, stream = _lib.prepare(
        name, cols + planes + ([t, z_r] if prep else []))
    N, Mj, Li = ins[0].shape
    levels = (N, N, N, N + 1) if prep else (N, N, N, N + 1, N, N + 1)
    want = [(n, Mj, Li) for n in levels] + [(Mj, Li)] * len(planes)
    NT = ins[-2].shape[0] if prep else 0
    if prep:
        want += [(NT, N, Mj, Li), (N, Mj, Li)]
    if N < 2 or [tuple(x.shape) for x in ins] != want:
        raise ValueError(f"{name}: inconsistent shapes")
    threads, _, smem = prep_launch_shape(N, Mj, Li, ins[0].element_size())
    if smem > _lib.SMEM_PER_BLOCK:
        raise ValueError(f"{name}: {N} levels need {smem} B of shared "
                         "memory a block, more than the card's 227 KB")
    z_w = ins[3] if prep else ins[5]
    Akv, hsbl = torch.empty_like(z_w), torch.empty_like(z_w[0])
    if prep:
        u_r, v_r, Hz, z_w, *pl = ins[:11]
        t, z_r = ins[11:]
        rho_out = [torch.empty_like(u_r), torch.empty_like(u_r),
                   torch.empty_like(u_r[0]), torch.empty_like(u_r[0])]
        ins = [t, z_r, Hz, z_w, u_r, v_r] + pl
        nat = cfg.NAT
        Akt = torch.empty((nat, N + 1, Mj, Li), dtype=z_w.dtype,
                          device=z_w.device)
        ghats = torch.empty((2 if nat > 1 else 1, N + 1, Mj, Li),
                            dtype=z_w.dtype, device=z_w.device)
        ghT = ghats[0]
        ghS = ghats[1] if nat > 1 else torch.empty_like(z_w)
        Akt_prof = Akt[0]
    else:
        rho_out, nat, Akt, ghats = [], 1, None, None
        Akt_prof, ghT, ghS = (torch.empty_like(z_w) for _ in range(3))
    kout = [Akv, Akt_prof, ghT, ghS, hsbl]
    e = cfg.eos
    pk = kpp_params(cfg)
    P, I, D = _lib.P, _lib.I, _lib.D
    args = ins + rho_out + kout
    fn = _lib.func(f"roms_{name}_{sfx}",
                   [P] * len(args) + [I] * 7 + [D] * 18 + [P])
    rc = fn(*[_lib.ptr(x) for x in args], NT, N, Mj * Li, nat, threads,
            int(bool(e.linear)), int(NT > 1 and e.Scoef != 0.0),
            e.R0, e.T0, e.S0, e.R0 * e.Tcoef, e.R0 * e.Scoef,
            -(constants.g / cfg.rho0), -constants.g, 1.0 / cfg.rho0,
            2.0 * (1.0 / cfg.rho0),
            pk["akv_bak"], pk["akt_bak0"], pk["r1"], pk["o_mu1"],
            pk["o_mu2"], pk["neg_gorho0"], pk["Vtc"], pk["Cg"],
            constants.vonKar, P(stream))
    _lib.launches[name] += 1
    _lib.check(rc, name)
    return (*rho_out, *kout), Akt, ghats


def lmd_kpp_fused(cfg, grid, t, u, v, pden, bvf, Hz, z_r, z_w, forcing,
                  use_kernels: bool = True):
    """LMD-KPP of the BENCHMARK physics (no BKPP/DDMIX) from the EOS
    outputs: returns (Akv, Akt, ghats, hsbl), Akt and ghats stacked over
    the NAT active tracers."""
    (u_r, v_r, Ustar, Bo, Bosol, absf, flxT, flxS,
     srflx) = surface_forcing(cfg, grid, t, u, v, forcing)
    fn = kpp if use_kernels else kpp_plain
    Akv, Akt_prof, ghT, ghS, hsbl = fn(
        cfg, u_r, v_r, pden, bvf, Hz, z_w, Ustar, Bo, Bosol, absf, flxT,
        flxS, srflx)
    return (Akv, *stack_tracers(cfg, Akt_prof, ghT, ghS), hsbl)
