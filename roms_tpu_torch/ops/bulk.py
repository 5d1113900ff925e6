"""Kernel 13: COARE 3.0 bulk air-sea fluxes with the stresses staggered to
U and V points (csrc/bulk.cu).

Replaces roms_tpu/ops/pallas_bulk.py `bulk_flux_pallas`.  The plain
version is core/bulk_flux.py `bulk_flux_rho` with the U/V staggering of
the stresses (`stagger_stress`), which roms_tpu does outside its kernel
and the port's C entry does on the card, so the wrapper launches no
PyTorch operation.  `covers` is every configuration: roms_tpu's gate
(`use_pallas_kpp`) has no config class, and the step takes this kernel
wherever the forcing function takes the ocean surface state.
"""

from __future__ import annotations

import torch

from .. import constants
from . import _lib

# AtmState fields in the kernel's argument order
FIELDS = ("Uwind", "Vwind", "Tair", "Pair", "Hair", "cloud", "rain",
          "srflx")
# threads a block of the bulk kernel and of the staggering kernel after it
SHAPE = 256


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
    Mj, Li = sst.shape
    ins = [getattr(atm, f).expand(Mj, Li) for f in FIELDS] + [sst, sss,
                                                               rho_surf]
    ins, sfx, stream = _lib.prepare("bulk_flux", ins)
    return _launch(cfg, sfx, stream, ins, cool_skin, coare35)


def _launch(cfg, sfx, stream, ins, cool_skin, coare35):
    """One C call: the bulk kernel writes the rho-point stresses to two
    scratch planes and a second kernel staggers them; returns (sustr,
    svstr, stflx_T, stflx_S)."""
    from ..core.bulk_flux import _FC, ribcu
    Mj, Li = ins[8].shape
    scratch = [torch.empty_like(ins[8]) for _ in range(2)]
    outs = [torch.empty_like(ins[8]) for _ in range(4)]
    P, I, D = _lib.P, _lib.I, _lib.D
    fn = _lib.func(f"roms_bulk_flux_{sfx}",
                   [P] * 17 + [I] * 5 + [D] * 9 + [P])
    rc = fn(*[_lib.ptr(x) for x in ins + scratch + outs], Mj, Li, SHAPE,
            int(bool(cool_skin)), int(bool(coare35)), cfg.rho0,
            constants.Cp, constants.g, constants.vonKar, cfg.blk_zw,
            cfg.blk_zt, cfg.blk_zq, 1.0 / ribcu(cfg.blk_zw), _FC, P(stream))
    _lib.launches["bulk_flux"] += 1
    _lib.check(rc, "bulk_flux")
    return tuple(outs)
