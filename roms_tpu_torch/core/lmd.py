"""LMD-KPP helpers (port of part of roms_tpu/core/lmd.py; lmd_skpp.F,
lmd_swfrac.F).

The port runs the K-profile closure as one column kernel (ops/kpp.py,
ops/prep.py), whose plain version transliterates roms_tpu's in-kernel
block math.  This module holds what that kernel and the solar source
share: the LMD constants, the Jerlov shortwave fraction, the turbulent
velocity scales and the surface expansion coefficients.  The whole-array
routines (lmd_vmix_interior, lmd_skpp) and the bottom boundary layer and
double diffusion (LMD_BKPP, LMD_DDMIX) are not ported: the step refuses
`bkpp` and `ddmix` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from ..config import ModelConfig

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
