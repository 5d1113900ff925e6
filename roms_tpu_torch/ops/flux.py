"""Kernels 7 and 8: horizontal mass fluxes fused with the vertical mass flux
(csrc/flux.cu), entry points `flux_omega` and `omega`, on one kernel body:
one CUDA block per tile of columns marching k, each level staged in shared
memory (flux_omega's u, v and Hz, each mass flux formed once; omega's
given Huon and Hvom), the running sums kept in shared memory for the pass
that writes W.

Replaces roms_tpu/ops/pallas_flux.py `flux_omega_pallas` and
`omega_pallas`.  The kernel and its plain version agree at every point:
Huon/Hvom ring rows hold set_massflux's roll wrap, where the Pallas
kernel leaves other dead values.  `covers` is the class of
`use_pallas_flux` (pallas_flux.py:211): EW-periodic, not NS-periodic,
closed or gradient N/S zeta walls, no OMEGA_IMPLICIT.
"""

from __future__ import annotations

import torch

from ..config import CLOSED, GRADIENT
from . import _lib, stencil as st

# the tile (rows, lanes): the tile grown by a row north and a lane east,
# (TJ + 1) x (TI + 1) positions, has a thread a position
TILE = (7, 31)
THREADS = 256
STAGES = 3         # level buffers of the cp.async pipeline (csrc kStages)


def launch_shape(N: int, Mj: int, Li: int, itemsize: int,
                 with_flux: bool = True):
    """(TJ, TI, blocks, dynamic shared memory bytes) of a launch of
    csrc/flux.cu flux_omega_kernel: the tiles of `_lib.seam_tiles`, STAGES
    buffers of a level's staged planes and the running sums of levels
    0..N-2 at each tile point.  flux_omega stages the Hz window (the tile
    grown by a row and a lane each side), u (grown a lane east) and v
    (grown a row north) and keeps the level's Huon and Hvom on the same
    positions as u and v; omega (`with_flux=False`) stages the given Huon
    and Hvom on u's and v's positions."""
    TJ, TI, blocks = _lib.seam_tiles(Mj, Li, TILE)
    nU, nV = TJ * (TI + 1), (TJ + 1) * TI
    if with_flux:
        per = STAGES * ((TJ + 2) * (TI + 2) + nU + nV) + nU + nV
    else:
        per = STAGES * (nU + nV)
    return TJ, TI, blocks, itemsize * (per + (N - 1) * TJ * TI)


def covers(cfg) -> bool:
    z = cfg.bc.zeta
    return (cfg.bc.ew_periodic and not cfg.bc.ns_periodic
            and z.south in (CLOSED, GRADIENT)
            and z.north in (CLOSED, GRADIENT)
            and not cfg.omega_implicit)


def flux_omega_plain(cfg, grid, u, v, Hz, z_w):
    """(Huon, Hvom, W): set_massflux, the EW ring refresh, omega."""
    from ..core.omega import omega as omega_fn
    from ..grid.depth import set_massflux
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    return Huon, Hvom, omega_fn(cfg, grid, Huon, Hvom, z_w)


def omega_plain(cfg, grid, Huon, Hvom, z_w):
    from ..core.omega import omega as omega_fn
    return omega_fn(cfg, grid, Huon, Hvom, z_w)


def flux_omega(cfg, grid, u, v, Hz, z_w):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if u.device.type == "cpu":
        return flux_omega_plain(cfg, grid, u, v, Hz, z_w)
    (u, v, Hz, on_u, om_v, z_w), sfx, stream = _lib.prepare(
        "flux_omega", [u, v, Hz, grid.on_u, grid.om_v, z_w])
    Huon, Hvom = torch.empty_like(u), torch.empty_like(v)
    W = _launch("flux_omega", cfg, sfx, stream, u, v, Hz, on_u, om_v, z_w,
                Huon, Hvom)
    return Huon, Hvom, W


def omega(cfg, grid, Huon, Hvom, z_w):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if Huon.device.type == "cpu":
        return omega_plain(cfg, grid, Huon, Hvom, z_w)
    (Huon, Hvom, z_w), sfx, stream = _lib.prepare("omega", [Huon, Hvom, z_w])
    return _launch("omega", cfg, sfx, stream, None, None, None, None, None,
                   z_w, Huon, Hvom)


def _launch(name, cfg, sfx, stream, u, v, Hz, on_u, om_v, z_w, Huon, Hvom):
    if not covers(cfg):
        raise NotImplementedError(
            f"{name} kernel covers EW-periodic grids with closed or "
            "gradient N/S zeta walls, without OMEGA_IMPLICIT")
    N, Mj, Li = Huon.shape
    if z_w.shape != (N + 1, Mj, Li) or Hvom.shape != Huon.shape or any(
            x is not None and x.shape[-2:] != (Mj, Li)
            for x in (u, v, Hz, on_u, om_v)) or Li < 4 or Mj < 4:
        raise ValueError(f"{name}: inconsistent shapes")
    TJ, TI, _, smem = launch_shape(N, Mj, Li, Huon.element_size(),
                                   name == "flux_omega")
    if smem > _lib.SMEM_PER_BLOCK or (TJ + 1) * (TI + 1) > THREADS:
        raise ValueError(
            f"{name}: {N} levels on a {TJ}x{TI} tile need {smem} B of shared "
            f"memory (at most 227 KB) and {(TJ + 1) * (TI + 1)} threads (at "
            f"most {THREADS})")
    W = torch.empty_like(z_w)
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_flux_omega_{sfx}", [I] + [P] * 9 + [I] * 5 + [P])
    rc = fn(int(name == "flux_omega"),
            *[P(None) if x is None else _lib.ptr(x)
              for x in (u, v, Hz, on_u, om_v, z_w, Huon, Hvom, W)],
            N, Mj, Li, TJ, TI, P(stream))
    _lib.launches[name] += 1
    _lib.check(rc, name)
    return W
