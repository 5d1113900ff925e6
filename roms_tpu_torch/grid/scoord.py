"""Terrain-following vertical coordinate stretching.

Re-implements the five stretching functions and two transforms of the
reference (ROMS/Utility/set_scoord.F:170-532).  Runs host-side in float64 at
setup time; results are small 1-D tables baked into the Grid pytree.

Conventions: N vertical rho-levels; s in [-1, 0];
  sc_w[k], Cs_w[k] for k = 0..N  (w interfaces, 0 = bottom)
  sc_r[k], Cs_r[k] for k = 0..N-1 (rho mid-levels)
"""

from __future__ import annotations

import numpy as np

from ..config import VerticalCoordConfig


def stretching(vc: VerticalCoordConfig):
    """Return (sc_r, Cs_r, sc_w, Cs_w) as float64 numpy arrays."""
    N = vc.N
    theta_s = float(vc.theta_s)
    theta_b = float(vc.theta_b)
    ds = 1.0 / N

    k_w = np.arange(0, N + 1, dtype=np.float64)
    k_r = np.arange(1, N + 1, dtype=np.float64)
    sc_w = ds * (k_w - N)
    sc_r = ds * (k_r - N - 0.5)

    V = vc.Vstretching
    if V == 1:
        # Song & Haidvogel (1994).  set_scoord.F:184-233
        if theta_s != 0.0:
            c1 = 1.0 / np.sinh(theta_s)
            c2 = 0.5 / np.tanh(0.5 * theta_s)

            def C(s):
                return ((1.0 - theta_b) * c1 * np.sinh(theta_s * s)
                        + theta_b * (c2 * np.tanh(theta_s * (s + 0.5)) - 0.5))
        else:
            def C(s):
                return s
        Cs_w = C(sc_w)
        Cs_r = C(sc_r)
    elif V == 2:
        # Shchepetkin 2005 double stretching.  set_scoord.F:240-315
        Aweight, Bweight = 1.0, 1.0

        def C(s):
            if theta_s > 0.0:
                csur = (1.0 - np.cosh(theta_s * s)) / (np.cosh(theta_s) - 1.0)
                if theta_b > 0.0:
                    cbot = np.sinh(theta_b * (s + 1.0)) / np.sinh(theta_b) - 1.0
                    w = ((s + 1.0) ** Aweight
                         * (1.0 + (Aweight / Bweight)
                            * (1.0 - (s + 1.0) ** Bweight)))
                    return w * csur + (1.0 - w) * cbot
                return csur
            return s
        Cs_w = C(sc_w)
        Cs_r = C(sc_r)
        Cs_w[0], Cs_w[-1] = -1.0, 0.0
    elif V == 3:
        # R. Geyer bottom-boundary-layer stretching.  set_scoord.F:322-386
        Hscale = 3.0
        exp_sur, exp_bot = theta_s, theta_b

        def C(s):
            cbot = (np.log(np.cosh(Hscale * (s + 1.0) ** exp_bot))
                    / np.log(np.cosh(Hscale)) - 1.0)
            csur = -(np.log(np.cosh(Hscale * np.abs(s) ** exp_sur))
                     / np.log(np.cosh(Hscale)))
            w = 0.5 * (1.0 - np.tanh(Hscale * (s + 0.5)))
            return w * cbot + (1.0 - w) * csur
        Cs_w = C(sc_w)
        Cs_r = C(sc_r)
        Cs_w[0], Cs_w[-1] = -1.0, 0.0
    elif V == 4:
        # Shchepetkin 2010 double stretching.  set_scoord.F:393-473
        def C(s):
            if theta_s > 0.0:
                csur = (1.0 - np.cosh(theta_s * s)) / (np.cosh(theta_s) - 1.0)
            else:
                csur = -(s ** 2)
            if theta_b > 0.0:
                return ((np.exp(theta_b * csur) - 1.0)
                        / (1.0 - np.exp(-theta_b)))
            return csur
        Cs_w = C(sc_w)
        Cs_r = C(sc_r)
        Cs_w[0], Cs_w[-1] = -1.0, 0.0
    elif V == 5:
        # Souza et al. 2015 quadratic-Legendre.  set_scoord.F:486-531
        rN = float(N)

        def sfun(rk):
            return (-(rk * rk - 2.0 * rk * rN + rk + rN * rN - rN)
                    / (rN * rN - rN)
                    - 0.01 * (rk * rk - rk * rN) / (1.0 - rN))
        sc_w = sfun(k_w)
        sc_r = sfun(k_r - 0.5)
        sc_w[0], sc_w[-1] = -1.0, 0.0

        def C(s):
            if theta_s > 0.0:
                csur = (1.0 - np.cosh(theta_s * s)) / (np.cosh(theta_s) - 1.0)
            else:
                csur = -(s ** 2)
            if theta_b > 0.0:
                return ((np.exp(theta_b * csur) - 1.0)
                        / (1.0 - np.exp(-theta_b)))
            return csur
        Cs_w = C(sc_w)
        Cs_r = C(sc_r)
        Cs_w[0], Cs_w[-1] = -1.0, 0.0
    else:
        raise ValueError(f"unknown Vstretching={V}")

    if V == 1:
        Cs_w[0] = -1.0
    return sc_r, Cs_r, sc_w, Cs_w


def compute_hc(vc: VerticalCoordConfig, hmin: float) -> float:
    """Critical depth hc (set_scoord.F:170-178)."""
    if vc.Vtransform == 1:
        return min(hmin, vc.Tcline)
    elif vc.Vtransform == 2:
        return float(vc.Tcline)
    raise ValueError(f"unknown Vtransform={vc.Vtransform}")
