"""Equation of state (port of roms_tpu/core/rho_eos.py).

Linear EOS (rho_eos.F:694-723) and the Jackett & McDougall (1995)
polynomial (rho_eos.F:12-37).  The column routine that also produces
rhoA/rhoS/bvf is kernel 1 (ops/rho.py); `rho_eos` dispatches to it.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig


def rho_eos_linear(cfg: ModelConfig, t):
    """t: (NT, N, Mj, Li); density anomaly rho (N, Mj, Li)."""
    e = cfg.eos
    rho = e.R0 - e.R0 * e.Tcoef * (t[0] - e.T0)
    if cfg.NT > 1 and e.Scoef != 0.0:
        rho = rho + e.R0 * e.Scoef * (t[1] - e.S0)
    return rho - 1000.0


# Jackett & McDougall (1995) coefficients (mod_eoscoef.F)
_Q = dict(
    Q00=+9.99842594e+2, Q01=+6.793952e-2, Q02=-9.095290e-3,
    Q03=+1.001685e-4, Q04=-1.120083e-6, Q05=+6.536332e-9,
    U00=+8.24493e-1, U01=-4.08990e-3, U02=+7.64380e-5,
    U03=-8.24670e-7, U04=+5.38750e-9,
    V00=-5.72466e-3, V01=+1.02270e-4, V02=-1.65460e-6,
    W00=+4.8314e-4,
    A00=+1.909256e+4, A01=+2.098925e+2, A02=-3.041638e+0,
    A03=-1.852732e-3, A04=-1.361629e-5,
    B00=+1.044077e+2, B01=-6.500517e+0, B02=+1.553190e-1,
    B03=+2.326469e-4,
    D00=-5.587545e+0, D01=+7.390729e-1, D02=-1.909078e-2,
    E00=+4.721788e-1, E01=+1.028859e-2, E02=-2.512549e-4,
    E03=-5.939910e-7,
    F00=-1.571896e-2, F01=-2.598241e-4, F02=+7.267926e-6,
    G00=+2.042967e-3,
    G01=+1.045941e-5, G02=-5.782165e-10, G03=+1.296821e-7,
    H00=-2.595994e-7, H01=-1.248266e-9, H02=-3.508914e-9,
)


def _jm95_parts(cfg: ModelConfig, t):
    """Depth-independent JM95 pieces (rho_eos.F:270-325): returns
    (T, S, sqrtS, den1, b0, b1, b2), bulk(z) = b0 - z*(b1 - z*b2)."""
    Q = _Q
    T = torch.clamp(t[0], min=-2.0)
    S = torch.clamp(t[1], min=0.0) if cfg.NT > 1 else torch.zeros_like(T)
    sqrtS = torch.sqrt(S)
    den1 = (Q["Q00"] + T * (Q["Q01"] + T * (Q["Q02"] + T * (Q["Q03"]
            + T * (Q["Q04"] + T * Q["Q05"]))))
            + S * (Q["U00"] + T * (Q["U01"] + T * (Q["U02"]
                   + T * (Q["U03"] + T * Q["U04"]))))
            + S * sqrtS * (Q["V00"] + T * (Q["V01"] + T * Q["V02"]))
            + S * S * Q["W00"])
    b0 = (Q["A00"] + T * (Q["A01"] + T * (Q["A02"] + T * (Q["A03"]
          + T * Q["A04"])))
          + S * (Q["B00"] + T * (Q["B01"] + T * (Q["B02"] + T * Q["B03"])))
          + S * sqrtS * (Q["D00"] + T * (Q["D01"] + T * Q["D02"])))
    b1 = (Q["E00"] + T * (Q["E01"] + T * (Q["E02"] + T * Q["E03"]))
          + S * (Q["F00"] + T * (Q["F01"] + T * Q["F02"]))
          + S * sqrtS * Q["G00"])
    b2 = (Q["G01"] + T * (Q["G02"] + T * Q["G03"])
          + S * (Q["H00"] + T * (Q["H01"] + T * Q["H02"])))
    return T, S, sqrtS, den1, b0, b1, b2


def rho_eos_jm95(cfg: ModelConfig, t, z_r):
    """Nonlinear in-situ density anomaly (Jackett & McDougall 1995)."""
    _, _, _, den1, b0, b1, b2 = _jm95_parts(cfg, t)
    bulk = b0 - z_r * (b1 - z_r * b2)
    rho = den1 * bulk / (bulk + 0.1 * z_r)
    return rho - 1000.0


def eos_alpha_beta(cfg: ModelConfig, t, z_r):
    """Thermal expansion alpha (1/C), saline contraction beta (1/PSU) and
    their ratio alfaobeta = Tcof/Scof of the JM95 polynomial at every
    level given, from its derivatives written out (rho_eos.F:276-340,
    427-465, EOS_TDERIVATIVE), as roms_tpu's `eos_alpha_beta(...,
    all_levels=True)` writes them, whatever the configuration's EOS:
    LMD_DDMIX's profile at the interior W interfaces (core/stepping.py
    passes T and S averaged to z_w)."""
    Q = _Q
    T, S, sqrtS, den1, b0, b1, b2 = _jm95_parts(cfg, t)

    # d(den1)/dT, d(den1)/dS (rho_eos.F:276-296)
    dC0 = Q["Q01"] + T * (2.0 * Q["Q02"] + T * (3.0 * Q["Q03"]
          + T * (4.0 * Q["Q04"] + T * 5.0 * Q["Q05"])))
    dC1 = Q["U01"] + T * (2.0 * Q["U02"] + T * (3.0 * Q["U03"]
          + T * 4.0 * Q["U04"]))
    dC2 = Q["V01"] + T * 2.0 * Q["V02"]
    C1 = Q["U00"] + T * (Q["U01"] + T * (Q["U02"] + T * (Q["U03"]
         + T * Q["U04"])))
    C2 = Q["V00"] + T * (Q["V01"] + T * Q["V02"])
    Dden1DS = C1 + 1.5 * C2 * sqrtS + 2.0 * Q["W00"] * S
    Dden1DT = dC0 + S * (dC1 + sqrtS * dC2)

    # d(bulk)/dT, d(bulk)/dS (rho_eos.F:310-340)
    dC3 = Q["A01"] + T * (2.0 * Q["A02"] + T * (3.0 * Q["A03"]
          + T * 4.0 * Q["A04"]))
    dC4 = Q["B01"] + T * (2.0 * Q["B02"] + T * 3.0 * Q["B03"])
    dC5 = Q["D01"] + T * 2.0 * Q["D02"]
    dC6 = Q["E01"] + T * (2.0 * Q["E02"] + T * 3.0 * Q["E03"])
    dC7 = Q["F01"] + T * 2.0 * Q["F02"]
    dC8 = Q["G02"] + T * 2.0 * Q["G03"]
    dC9 = Q["H01"] + T * 2.0 * Q["H02"]
    C4 = Q["B00"] + T * (Q["B01"] + T * (Q["B02"] + T * Q["B03"]))
    C5 = Q["D00"] + T * (Q["D01"] + T * Q["D02"])
    C7 = Q["F00"] + T * (Q["F01"] + T * Q["F02"])
    C9 = Q["H00"] + T * (Q["H01"] + T * Q["H02"])
    Tp = z_r
    DbulkDS = C4 + sqrtS * 1.5 * C5 - Tp * (C7 + sqrtS * 1.5 * Q["G00"]
                                            - Tp * C9)
    DbulkDT = dC3 + S * (dC4 + sqrtS * dC5) - Tp * (dC6 + S * dC7
              - Tp * (dC8 + S * dC9))

    # assemble (rho_eos.F:440-465)
    bulk = b0 - Tp * (b1 - Tp * b2)
    Tpr10 = 0.1 * Tp
    den = den1 * bulk / (bulk + Tpr10)
    cff = bulk + Tpr10
    cff1 = Tpr10 * den1
    cff2 = bulk * cff
    wrk = den * cff * cff
    Tcof = -(DbulkDT * cff1 + Dden1DT * cff2)
    Scof = (DbulkDS * cff1 + Dden1DS * cff2)
    return Tcof / wrk, Scof / wrk, Tcof / Scof


def rho_eos(cfg: ModelConfig, t, z_r, Hz, z_w, use_kernels: bool = True):
    """(rho, pden, rhoA, rhoS, bvf) — see ops/rho.py."""
    from ..ops import rho as rho_op
    fn = rho_op.rho_eos if use_kernels else rho_op.rho_eos_plain
    return fn(cfg, t, z_r, Hz, z_w)
