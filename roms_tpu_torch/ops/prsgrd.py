"""Kernel 7: splines density-Jacobian pressure gradient (csrc/prsgrd.cu).

Replaces roms_tpu/ops/pallas_prsgrd.py `prsgrd32_pallas`; the plain
version is core/prsgrd.py `prsgrd32`.  The kernel and its plain version
agree at every point: the ring rows carry the roll-wrap values, which
the Pallas kernel zeroes.  `covers` is the class of `use_pallas_prsgrd`
(pallas_prsgrd.py:266) with the exclusions of roms_tpu/core/stepping.py
:383-385 (ice shelf; tide together with air pressure).
"""

from __future__ import annotations

import torch

from . import _lib


def covers(cfg, grid=None, eq_tide=None, Pair=None) -> bool:
    return (cfg.prsgrd == "djs" and cfg.bc.ew_periodic
            and not cfg.bc.ns_periodic
            and (grid is None or grid.zice is None)
            and not (eq_tide is not None and Pair is not None))


def prsgrd32_plain(cfg, grid, rho, z_r, z_w, Hz):
    from ..core.prsgrd import prsgrd32 as plain
    return plain(cfg, grid, rho, z_r, z_w, Hz)


def prsgrd32(cfg, grid, rho, z_r, z_w, Hz):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if rho.device.type == "cpu":
        return prsgrd32_plain(cfg, grid, rho, z_r, z_w, Hz)
    if not covers(cfg, grid):
        raise NotImplementedError(
            "prsgrd32 kernel covers the djs scheme on EW-periodic, "
            "non-NS-periodic grids without an ice shelf")
    N, Mj, Li = rho.shape
    (rho, z_r, Hz, zw_top, umask, vmask, on_u, om_v), sfx, stream = \
        _lib.prepare("prsgrd32", [rho, z_r, Hz, z_w[N], grid.umask,
                                  grid.vmask, grid.on_u, grid.om_v])
    if z_r.shape != rho.shape or Hz.shape != rho.shape or \
            z_w.shape != (N + 1, Mj, Li) or N < 2 or Li < 4:
        raise ValueError("prsgrd32: inconsistent shapes")
    ru, rv = torch.empty_like(rho), torch.empty_like(rho)
    GRho = cfg.g / cfg.rho0
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_prsgrd32_{sfx}", [P] * 10 + [I] * 3 + [D] * 3
                   + [P])
    rc = fn(*[_lib.ptr(x) for x in (rho, z_r, Hz, zw_top, umask, vmask,
                                    on_u, om_v, ru, rv)],
            N, Mj, Li, cfg.g * (1.0 - cfg.sal_scalar), GRho, 0.5 * GRho,
            P(stream))
    _lib.launches["prsgrd32"] += 1
    _lib.check(rc, "prsgrd32")
    return ru, rv
