"""Kernel 13: COARE 3.0 bulk air-sea fluxes (csrc/bulk.cu).

Replaces roms_tpu/ops/pallas_bulk.py `bulk_flux_pallas`.  The plain
version is core/bulk_flux.py `bulk_flux_rho` with the U/V staggering of
the stresses, which roms_tpu also does outside its kernel.  `covers` is
every configuration: roms_tpu's gate (`use_pallas_kpp`) has no config
class, and the step takes this kernel wherever the forcing function
takes the ocean surface state.
"""

from __future__ import annotations

import torch

from .. import constants
from . import _lib

# AtmState fields in the kernel's argument order
FIELDS = ("Uwind", "Vwind", "Tair", "Pair", "Hair", "cloud", "rain",
          "srflx")


def covers(cfg) -> bool:
    return True


def bulk_flux_plain(cfg, atm, sst, sss, rho_surf, cool_skin=False,
                    coare35=False):
    """(sustr, svstr, stflx_T, stflx_S)."""
    from ..core.bulk_flux import bulk_flux_rho, stagger_stress
    Taux, Tauy, stT, stS, *_ = bulk_flux_rho(
        cfg, atm, sst, sss, rho_surf, cool_skin=cool_skin, coare35=coare35)
    return (*stagger_stress(cfg, Taux, Tauy), stT, stS)


def bulk_flux(cfg, atm, sst, sss, rho_surf, cool_skin=False,
              coare35=False):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if sst.device.type == "cpu":
        return bulk_flux_plain(cfg, atm, sst, sss, rho_surf, cool_skin,
                               coare35)
    from ..core.bulk_flux import _FC, ribcu, stagger_stress
    shp = sst.shape
    ins = [getattr(atm, f).expand(shp) for f in FIELDS] + [sst, sss,
                                                            rho_surf]
    ins, sfx, stream = _lib.prepare("bulk_flux", ins)
    outs = [torch.empty_like(ins[8]) for _ in range(4)]
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_bulk_flux_{sfx}",
                   [P] * 15 + [I] * 3 + [D] * 9 + [P])
    rc = fn(*[_lib.ptr(x) for x in ins + outs], shp[0] * shp[1],
            int(bool(cool_skin)), int(bool(coare35)), cfg.rho0,
            constants.Cp, constants.g, constants.vonKar, cfg.blk_zw,
            cfg.blk_zt, cfg.blk_zq, 1.0 / ribcu(cfg.blk_zw), _FC, P(stream))
    _lib.launches["bulk_flux"] += 1
    _lib.check(rc, "bulk_flux")
    Taux, Tauy, stT, stS = outs
    return (*stagger_stress(cfg, Taux, Tauy), stT, stS)
