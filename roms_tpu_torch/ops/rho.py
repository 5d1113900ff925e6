"""Kernel 1: column equation of state (csrc/rho.cu).

Replaces roms_tpu/ops/pallas_rho.py `rho_eos_pallas`.  `rho_eos` is the
wrapper: plain version for CPU tensors, CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import constants
from . import _lib


def rho_eos_plain(cfg, t, z_r, Hz, z_w):
    """(rho, pden, rhoA, rhoS, bvf): core/rho_eos.py math with the
    top-down rhoA/rhoS accumulation of the kernel (rho_eos.F:731-741)."""
    from ..core.rho_eos import _jm95_parts, rho_eos_linear
    N = z_r.shape[0]
    if cfg.eos.linear:
        rho = rho_eos_linear(cfg, t)
        pden = rho
        bvf_i = -(constants.g / cfg.rho0) * (pden[1:] - pden[:-1]) \
            / (z_r[1:] - z_r[:-1])
    else:
        _, _, _, den1, b0, b1, b2 = _jm95_parts(cfg, t)
        bulk = b0 - z_r * (b1 - z_r * b2)
        rho = den1 * bulk / (bulk + 0.1 * z_r) - 1000.0
        pden = den1 - 1000.0
        zw_i = z_w[1:-1]
        bulk_up = b0[1:] - zw_i * (b1[1:] - b2[1:] * zw_i)
        bulk_dn = b0[:-1] - zw_i * (b1[:-1] - b2[:-1] * zw_i)
        den_up = den1[1:] * bulk_up / (bulk_up + 0.1 * zw_i)
        den_dn = den1[:-1] * bulk_dn / (bulk_dn + 0.1 * zw_i)
        bvf_i = -constants.g * (den_up - den_dn) / \
            (0.5 * (den_up + den_dn) * (z_r[1:] - z_r[:-1]))
    rhoA = rho[N - 1] * Hz[N - 1]
    rhoS = 0.5 * rhoA * Hz[N - 1]
    for k in range(N - 2, -1, -1):
        cff1 = rho[k] * Hz[k]
        rhoS = rhoS + Hz[k] * (rhoA + 0.5 * cff1)
        rhoA = rhoA + cff1
    D_inv = 1.0 / (z_w[N] - z_w[0])
    o_rho0 = 1.0 / cfg.rho0
    rhoA = o_rho0 * D_inv * rhoA
    rhoS = 2.0 * o_rho0 * D_inv * D_inv * rhoS
    zeros = torch.zeros_like(bvf_i[:1])
    bvf = torch.cat([zeros, bvf_i, zeros], dim=0)
    return rho, pden, rhoA, rhoS, bvf


def covers(cfg) -> bool:
    """Every configuration (use_pallas_rho has no config class)."""
    return True


def rho_eos(cfg, t, z_r, Hz, z_w):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if t.device.type == "cpu":
        return rho_eos_plain(cfg, t, z_r, Hz, z_w)
    return rho_eos_cuda(cfg, t, z_r, Hz, z_w)


def rho_eos_cuda(cfg, t, z_r, Hz, z_w):
    (t, z_r, Hz, z_w), sfx, stream = _lib.prepare(
        "rho_eos", [t, z_r, Hz, z_w])
    NT, N, Mj, Li = t.shape
    if z_r.shape != (N, Mj, Li) or Hz.shape != z_r.shape or \
            z_w.shape != (N + 1, Mj, Li) or N < 2:
        raise ValueError("rho_eos: inconsistent shapes")
    rho = torch.empty_like(z_r)
    pden = torch.empty_like(z_r)
    rhoA = torch.empty_like(z_r[0])
    rhoS = torch.empty_like(z_r[0])
    bvf = torch.empty_like(z_w)
    e = cfg.eos
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_rho_eos_{sfx}", [P] * 9 + [I] * 5 + [D] * 9 + [P])
    rc = fn(*[_lib.ptr(x) for x in (t, z_r, Hz, z_w, rho, pden, rhoA,
                                    rhoS, bvf)],
            NT, N, Mj * Li, int(bool(e.linear)),
            int(NT > 1 and e.Scoef != 0.0),
            e.R0, e.T0, e.S0, e.R0 * e.Tcoef, e.R0 * e.Scoef,
            -(constants.g / cfg.rho0), -constants.g, 1.0 / cfg.rho0,
            2.0 * (1.0 / cfg.rho0), P(stream))
    _lib.launches["rho_eos"] += 1
    _lib.check(rc, "rho_eos")
    return rho, pden, rhoA, rhoS, bvf
