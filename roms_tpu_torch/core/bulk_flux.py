"""COARE 3.0 bulk air-sea fluxes (port of roms_tpu/core/bulk_flux.py;
Fairall et al. 1996/2003, ROMS/Nonlinear/bulk_flux.F open-water path).

Saturation humidity, three fixed Monin-Obukhov passes (IterMax=3),
Charnock roughness, the stability functions bulk_psiu/psit, latent,
sensible and Berliand longwave fluxes, wind stress and the E-P salt
flux.  `bulk_flux_rho` is the elementwise core and the plain version of
kernel 13 (ops/bulk.py, csrc/bulk.cu).

Rounding discipline shared with the kernel: a tensor is never divided by
a Python constant (it is multiplied by the reciprocal, which PyTorch's
CUDA division does anyway and its CPU division does not), and a constant
over a tensor is a true division (`_rdiv`; PyTorch's `c / x` is
reciprocal(x) * c).  Integer powers are written as products.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants
from ..config import ModelConfig
from ..ops import stencil as st
from .state import Forcing

# mod_scalars.F:460-462, 1496-1500, 4545-4547
STEFBO = 5.67e-8
EMMISS = 0.97
RHOW = 1000.0
BLK_CPA = 1004.67
BLK_CPW = 4000.0
BLK_RGAS = 287.1
BLK_ZABL = 600.0
BLK_BETA = 1.2

_EPS = 1.0e-20
_PI = math.pi
_S3 = math.sqrt(3.0)
# cool-skin constants (bulk_flux.F:894-938)
_HCOOL = 0.001
_FC = 0.065 + 11.0 * _HCOOL - \
    (1.0 - math.exp(-_HCOOL * 1250.0)) * 6.6e-5 / _HCOOL


def ribcu(zw: float) -> float:
    """Critical bulk Richardson number of free convection."""
    return -zw / (BLK_ZABL * 0.004 * BLK_BETA ** 3)


class AtmState(NamedTuple):
    """Atmospheric forcing fields at RHO points, each (Mj, Li)."""
    Uwind: torch.Tensor     # 10-m wind (m/s)
    Vwind: torch.Tensor
    Tair: torch.Tensor      # air temperature (Celsius)
    Pair: torch.Tensor      # sea-level pressure (mb)
    Hair: torch.Tensor      # relative humidity (fraction) or g/kg if >=2
    cloud: torch.Tensor     # cloud fraction
    rain: torch.Tensor      # kg/m2/s
    srflx: torch.Tensor     # shortwave (Celsius m/s), incl. albedo


def _rdiv(c: float, x):
    """c / x as one true division."""
    return torch.full_like(x, c) / x


def _arctan(x):
    """arctan via double range reduction + odd Taylor polynomial, as
    roms_tpu's Pallas kernel and jnp path both compute it (accurate to
    ~2e-9): atan(x) = sign(x) atan(|x|); |x| > 1 -> pi/2 - atan(1/|x|);
    t > tan(pi/8) -> pi/4 + atan((t-1)/(t+1))."""
    sgn = torch.sign(x)
    t = torch.abs(x)
    big = t > 1.0
    t = torch.where(big, 1.0 / torch.clamp(t, min=1.0e-30), t)
    fold = t > 0.4142135623730951
    u = torch.where(fold, (t - 1.0) / (t + 1.0), t)
    u2 = u * u
    # odd Taylor series sum u^(2k+1) (-1)^k/(2k+1), k=0..7
    p = -1.0 / 15.0 * u2 + 1.0 / 13.0
    for c in (-1.0 / 11.0, 1.0 / 9.0, -1.0 / 7.0, 1.0 / 5.0, -1.0 / 3.0,
              1.0):
        p = p * u2 + c
    a = u * p
    a = torch.where(fold, 0.25 * _PI + a, a)
    a = torch.where(big, 0.5 * _PI - a, a)
    return sgn * a


def _psi_convective(y):
    """The free-convection limit shared by bulk_psiu and bulk_psit."""
    return (1.5 * torch.log((1.0 / 3.0) * (1.0 + y + y * y))
            - _S3 * _arctan((1.0 + 2.0 * y) * (1.0 / _S3)) + _PI / _S3)


def bulk_psiu(ZoL):
    """Momentum stability function (bulk_flux.F:1465-1528)."""
    x = torch.clamp(1.0 - 15.0 * ZoL, min=_EPS) ** 0.25
    psik = (2.0 * torch.log(0.5 * (1.0 + x))
            + torch.log(0.5 * (1.0 + x * x))
            - 2.0 * _arctan(x) + 0.5 * _PI)
    y = torch.clamp(1.0 - 10.15 * ZoL, min=_EPS) ** (1.0 / 3.0)
    psic = _psi_convective(y)
    Fw = ZoL * ZoL / (1.0 + ZoL * ZoL)
    unstable = (1.0 - Fw) * psik + Fw * psic
    cff = torch.clamp(0.35 * ZoL, max=50.0)
    stable = -((1.0 + ZoL) + 0.6667 * (ZoL - 14.28) / torch.exp(cff)
               + 8.525)
    return torch.where(ZoL < 0.0, unstable, stable)


def bulk_psit(ZoL):
    """Scalar stability function (bulk_flux.F:1530-1592)."""
    x = torch.sqrt(torch.clamp(1.0 - 15.0 * ZoL, min=_EPS))
    psik = 2.0 * torch.log(0.5 * (1.0 + x))
    y = torch.clamp(1.0 - 34.15 * ZoL, min=_EPS) ** (1.0 / 3.0)
    psic = _psi_convective(y)
    Fw = ZoL * ZoL / (1.0 + ZoL * ZoL)
    unstable = (1.0 - Fw) * psik + Fw * psic
    cff = torch.clamp(0.35 * ZoL, max=50.0)
    z15 = 1.0 + 2.0 * ZoL
    stable = -(z15 * torch.sqrt(torch.clamp(z15, min=0.0))
               + 0.6667 * (ZoL - 14.28) / torch.exp(cff) + 8.525)
    return torch.where(ZoL < 0.0, unstable, stable)


def _sat_vapor(TC, Pair):
    """Saturation vapour pressure (mb) (bulk_flux.F:700-720)."""
    return (1.0007 + 3.46e-6 * Pair) * 6.1121 * \
        torch.exp(17.502 * TC / (240.97 + TC))


def bulk_flux_rho(cfg: ModelConfig, atm: AtmState, sst, sss, rho_surf,
                  cool_skin: bool = False, coare35: bool = False):
    """COARE fluxes at rho points; the elementwise core shared by the
    plain path and kernel 13.  Returns (Taux, Tauy, stflx_T, stflx_S,
    lrflx, lhflx, shflx, evap) with the stresses at rho points in N/m2."""
    g = constants.g
    vonKar = constants.vonKar
    rho0 = cfg.rho0
    Hscale = rho0 * constants.Cp
    o_g = 1.0 / g
    zw, zt, zq = cfg.blk_zw, cfg.blk_zt, cfg.blk_zq

    Wmag = torch.sqrt(atm.Uwind * atm.Uwind + atm.Vwind * atm.Vwind)
    TairC = atm.Tair
    TairK = TairC + 273.16
    TseaC = sst
    TseaK = TseaC + 273.16
    RH = atm.Hair
    SRad = atm.srflx * Hscale

    # --- longwave (Berliand, LONGWAVE branch) ---------------------------
    cff = (0.7859 + 0.03477 * TairC) / (1.0 + 0.00412 * TairC)
    e_sat = torch.pow(10.0, cff)
    vap_p = e_sat * torch.where(RH < 2.0, RH, RH * 0.0 + 0.8)
    cff2 = TairK * TairK * TairK
    cff1 = cff2 * TairK
    LRad = -EMMISS * STEFBO * (
        cff1 * (0.39 - 0.05 * torch.sqrt(vap_p))
        * (1.0 - 0.6823 * atm.cloud * atm.cloud)
        + cff2 * 4.0 * (TseaK - TairK))

    # --- humidities ------------------------------------------------------
    cffa = _sat_vapor(TairC, atm.Pair)
    Qair = 0.62197 * cffa / (atm.Pair - 0.378 * cffa + _EPS)
    cffq = cffa * torch.where(RH < 2.0, RH, torch.ones_like(RH))
    Q = torch.where(RH < 2.0,
                    0.62197 * cffq / (atm.Pair - 0.378 * cffq + _EPS),
                    RH * (1.0 / 1000.0))
    cffs = _sat_vapor(TseaC, atm.Pair) * 0.98
    Qsea = 0.62197 * cffs / (atm.Pair - 0.378 * cffs)

    rhoAir = atm.Pair * 100.0 / (BLK_RGAS * TairK * (1.0 + 0.61 * Q))
    VisAir = 1.326e-5 * (1.0 + TairC * (6.542e-3 + TairC *
                                        (8.301e-6 - 4.84e-9 * TairC)))
    Hlv = (2.501 - 0.00237 * TseaC) * 1.0e6

    # --- first guesses (bulk_flux.F:735-800) -----------------------------
    Wgus = torch.full_like(Wmag, 0.5)
    delW = torch.sqrt(Wmag * Wmag + Wgus * Wgus)
    delQ = Qsea - Q
    delT = TseaC - TairC
    ZoW = torch.full_like(Wmag, 0.0001)
    u10 = delW * torch.log(_rdiv(10.0, ZoW)) / torch.log(_rdiv(zw, ZoW))
    Wstar = 0.035 * u10
    Zo10 = 0.011 * Wstar * Wstar * o_g + 0.11 * VisAir / Wstar
    Cd10 = _rdiv(vonKar, torch.log(_rdiv(10.0, Zo10)))
    Cd10 = Cd10 * Cd10
    Ch10 = 0.00115
    Ct10 = _rdiv(Ch10, torch.sqrt(Cd10))
    ZoT10 = _rdiv(10.0, torch.exp(_rdiv(vonKar, Ct10)))
    Cd = _rdiv(vonKar, torch.log(_rdiv(zw, Zo10)))
    Cd = Cd * Cd
    Ct = _rdiv(vonKar, torch.log(_rdiv(zt, ZoT10)))
    CC = vonKar * Ct / Cd
    o_ribcu = 1.0 / ribcu(zw)
    Ri = -g * zw * (delT + 0.61 * TairK * delQ) / \
        (TairK * delW * delW + _EPS)
    Zetu = torch.where(Ri < 0.0,
                       CC * Ri / (1.0 + Ri * o_ribcu),
                       CC * Ri / (1.0 + 3.0 * Ri / CC))
    L10 = _rdiv(zw, Zetu)
    Wstar = delW * vonKar / (torch.log(_rdiv(zw, Zo10))
                             - bulk_psiu(_rdiv(zw, L10)))
    Tstar = -delT * vonKar / (torch.log(_rdiv(zt, ZoT10))
                              - bulk_psit(_rdiv(zt, L10)))
    Qstar = -delQ * vonKar / (torch.log(_rdiv(zq, ZoT10))
                              - bulk_psit(_rdiv(zq, L10)))

    if coare35:
        # COARE 3.5 Charnock (Edson et al 2013; bulk_flux.F:795-797)
        charn = torch.clamp(-0.005 + 0.0017 * delW, max=0.028)
    else:
        # Charnock parameter (COARE 3.0 wind dependence)
        charn = torch.where(
            delW > 18.0, torch.full_like(delW, 0.018),
            torch.where(delW > 10.0,
                        0.011 + 0.125 * (0.018 - 0.011) * (delW - 10.0),
                        torch.full_like(delW, 0.011)))
    # cool-skin state (COOL_SKIN, Fairall et al 1996)
    delTc = torch.zeros_like(delT)
    delQc = torch.zeros_like(delQ)
    if cool_skin:
        Cwet = 0.622 * Hlv * Qsea / (BLK_RGAS * (TseaK * TseaK))
        Tcff = 2.1e-5 * torch.clamp(TseaC + 3.2, min=0.0) ** 0.79
        Scff = _rdiv(0.026, 1.0 - 0.026 * sss * (1.0 / 34.0) + _EPS) \
            * 0.0 + 0.026
        rhoSea = rho0 + rho_surf

    # --- Monin-Obukhov iteration (IterMax=3) -----------------------------
    for _ in range(3):
        ZoW = charn * Wstar * Wstar * o_g + 0.11 * VisAir / (Wstar + _EPS)
        Rr = ZoW * Wstar / VisAir
        ZoQ = torch.clamp(_rdiv(5.5e-5, Rr ** 0.6), max=1.15e-4)
        ZoT = ZoQ
        ZoL = vonKar * g * zw * \
            (Tstar * (1.0 + 0.61 * Q) + 0.61 * TairK * Qstar) / \
            (TairK * Wstar * Wstar * (1.0 + 0.61 * Q) + _EPS)
        L = _rdiv(zw, ZoL + _EPS)
        Wpsi = bulk_psiu(ZoL)
        Tpsi = bulk_psit(_rdiv(zt, L))
        Qpsi = bulk_psit(_rdiv(zq, L))
        Wstar = torch.clamp(delW * vonKar /
                            (torch.log(_rdiv(zw, ZoW)) - Wpsi), min=_EPS)
        Tstar = -(delT - delTc) * vonKar / \
            (torch.log(_rdiv(zt, ZoT)) - Tpsi)
        Qstar = -(delQ - delQc) * vonKar / \
            (torch.log(_rdiv(zq, ZoQ)) - Qpsi)
        Bf = _rdiv(-g, TairK) * Wstar * (Tstar + 0.61 * TairK * Qstar)
        Wgus = torch.where(Bf > 0.0,
                           BLK_BETA * torch.clamp(Bf * BLK_ZABL,
                                                  min=_EPS) ** (1.0 / 3.0),
                           torch.full_like(Bf, 0.2))
        delW = torch.sqrt(Wmag * Wmag + Wgus * Wgus)
        if cool_skin:
            # cool-skin correction (bulk_flux.F:894-938): molecular
            # sublayer cooling delTc, moisture counterpart delQc
            visw, tcw, Cpw = 1.0e-6, 0.6, BLK_CPW
            rv = rhoSea * visw
            Clam = 16.0 * g * Cpw * (rv * rv * rv) / \
                (tcw * tcw * rhoAir * rhoAir)
            Hsb = -rhoAir * BLK_CPA * Wstar * Tstar
            Hlb = -rhoAir * Hlv * Wstar * Qstar
            Qcool = LRad + Hsb + Hlb - SRad * _FC
            Qbouy = Tcff * Qcool + Scff * Hlb * Cpw / Hlv
            w2 = (Wstar + _EPS) * (Wstar + _EPS)
            lambd = _rdiv(6.0, (1.0 + (Clam * torch.clamp(Qbouy, min=0.0)
                                       / (w2 * w2)) ** 0.75)
                          ** (1.0 / 3.0))
            Hc = lambd * visw / (torch.sqrt(rhoAir / rhoSea) * Wstar
                                 + _EPS)
            delTc = torch.where((Qcool > 0.0) & (Qbouy > 0.0),
                                Qcool * Hc * (1.0 / tcw),
                                torch.zeros_like(Qcool))
            delQc = Cwet * delTc

    # --- fluxes (bulk_flux.F:900-1010) -----------------------------------
    Hs = -BLK_CPA * rhoAir * Wstar * Tstar
    diffw = 2.11e-5 * (TairK * (1.0 / 273.16)) ** 1.94
    diffh = 0.02411 * (1.0 + TairC * (3.309e-3 - 1.44e-6 * TairC)) / \
        (rhoAir * BLK_CPA + _EPS)
    cffw = Qair * Hlv / (BLK_RGAS * TairK * TairK)
    wet_bulb = 1.0 / (1.0 + 0.622 * (cffw * Hlv * diffw) /
                      (BLK_CPA * diffh))
    Hsr = torch.abs(atm.rain) * wet_bulb * BLK_CPW * \
        (delT + delQ * Hlv * (1.0 / BLK_CPA))
    SHeat = Hs + Hsr

    Hl = -Hlv * rhoAir * Wstar * Qstar
    upvel = -1.61 * Wstar * Qstar - \
        (1.0 + 1.61 * Q) * Wstar * Tstar / TairK
    Hlw = rhoAir * Hlv * upvel * Q
    LHeat = Hl + Hlw

    Taur = 0.85 * torch.abs(atm.rain) * Wmag
    cfft = rhoAir * (Wstar * Wstar + Taur / rhoAir) / (Wmag + _EPS)
    Taux = cfft * atm.Uwind
    Tauy = cfft * atm.Vwind

    oH = 1.0 / Hscale
    lrflx = LRad * oH
    lhflx = -LHeat * oH
    shflx = -SHeat * oH
    stflx_T = atm.srflx + lrflx + lhflx + shflx
    evap = LHeat / (Hlv + _EPS)
    stflx_S = (evap - atm.rain) * sss * (1.0 / RHOW)
    return Taux, Tauy, stflx_T, stflx_S, lrflx, lhflx, shflx, evap


def stagger_stress(cfg: ModelConfig, Taux, Tauy):
    """Rho-point stresses (N/m2) to kinematic U/V-point stresses
    (bulk_flux.F tail)."""
    sustr = 0.5 * (Taux + st.im1(Taux)) * (1.0 / cfg.rho0)
    svstr = 0.5 * (Tauy + st.jm1(Tauy)) * (1.0 / cfg.rho0)
    return sustr, svstr


def bulk_flux(cfg: ModelConfig, atm: AtmState, sst, sss, rho_surf,
              cool_skin: bool = False, coare35: bool = False):
    """Surface fluxes: (sustr, svstr, stflx_T, stflx_S, lrflx, lhflx,
    shflx, evap), stresses at U/V points (kinematic m2/s2), fluxes in
    Celsius m/s and PSU m/s."""
    (Taux, Tauy, stflx_T, stflx_S, lrflx, lhflx, shflx,
     evap) = bulk_flux_rho(cfg, atm, sst, sss, rho_surf,
                           cool_skin=cool_skin, coare35=coare35)
    sustr, svstr = stagger_stress(cfg, Taux, Tauy)
    return sustr, svstr, stflx_T, stflx_S, lrflx, lhflx, shflx, evap


def make_bulk_forcing(cfg: ModelConfig, atm_fn, cool_skin=False,
                      coare35=False):
    """Wrap an atmosphere function atm_fn(time) -> AtmState into a
    forcing function that needs the ocean surface state:
    forcing(time, sst, sss, rho_surf, use_kernels=True) -> Forcing.
    The Model passes its own `use_kernels`: True sends the fluxes
    through kernel 13's wrapper (ops/bulk.py), False through its plain
    version."""
    from ..ops import bulk as bulk_op

    def forcing(time, sst, sss, rho_surf, use_kernels=True):
        atm = atm_fn(time)
        fn = bulk_op.bulk_flux if use_kernels else bulk_op.bulk_flux_plain
        sustr, svstr, stT, stS = fn(cfg, atm, sst, sss, rho_surf,
                                    cool_skin=cool_skin, coare35=coare35)
        zeros = torch.zeros_like(sustr)
        stflx = torch.stack([stT, stS] + [zeros] * (cfg.NT - 2))
        return Forcing(sustr=sustr, svstr=svstr, stflx=stflx,
                       btflx=torch.zeros_like(stflx), srflx=atm.srflx)

    def components(time, sst, sss, rho_surf):
        """Write-time flux components of the history stream (wrt_his.F
        idLrad/idLhea/idShea/idEmPf/idrain/idPair/idTair/idUair/idVair),
        from this module's formulas as roms_tpu forms them (the kernel
        writes only what the step consumes)."""
        atm = atm_fn(time)
        (*_, lrflx, lhflx, shflx, evap) = bulk_flux_rho(
            cfg, atm, sst, sss, rho_surf, cool_skin=cool_skin,
            coare35=coare35)
        Hscale = cfg.rho0 * constants.Cp
        return {"lwrad": lrflx * Hscale, "latent": lhflx * Hscale,
                "sensible": shflx * Hscale, "evaporation": evap,
                "rain": atm.rain,
                "EminusP": evap / RHOW - atm.rain / RHOW,
                "Pair": atm.Pair, "Tair": atm.Tair,
                "Uwind": atm.Uwind, "Vwind": atm.Vwind}

    forcing.components = components
    return forcing
