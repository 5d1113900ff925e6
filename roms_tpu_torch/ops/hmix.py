"""Kernel 16: rotated (geopotential) triad divergence of every tracer
(csrc/hmix.cu): one CUDA block per tile of columns, marching k upwards
with every tracer at once, its levels, faces and fluxes in shared memory.

Replaces roms_tpu/ops/pallas_hmix.py `rot_div_geo_batched` and the
single-tracer `rot_div_geo_pallas` (t3dmix2_geo.h triad operator).  The
plain version is core/hmix.py `_rot_div_geo` applied to each tracer.

Ring rows: the Pallas kernel zeroes output rows j = 0 and Mj-1, where
the jnp path leaves roll-wrap values (dead data: the tracer BCs and
`_lap_bc` overwrite them).  The CUDA kernel keeps the jnp path's roll
wrap, so it equals its plain version over whole arrays.  `covers` is the
class of roms_tpu's kernel route (core/hmix.py:218-255): geopotential
(not isopycnal) tracer mixing with a nonzero coefficient on grids that
are not NS-periodic.
"""

from __future__ import annotations

import torch

from . import _lib
from . import stencil as st


# the tile (rows, lanes): the fastest of the tiles timed on the H100 at
# BENCHMARK3's shapes (PERF.md); up to three float64 tracers fit a block
TILE = (4, 64)


def launch_shape(NT: int, Mj: int, Li: int, itemsize: int):
    """(TJ, TI, blocks, dynamic shared memory bytes) of the kernel's
    launch (csrc/hmix.cu smem_bytes): window cells of the tile with a
    one-cell halo and four periodic source columns, U and V faces, tile
    cells."""
    TJ, TI = _lib.even_tiles(Mj, Li, TILE)
    WC = TI + 6
    cells, faces = (TJ + 2) * WC, TJ * (TI + 1) + (TJ + 1) * TI
    smem = itemsize * (cells * (2 + 3 * NT) + faces * (3 + 4 * NT)
                       + TJ * TI * (1 + 2 * NT)) + 4 * (TJ + 2 + WC
                                                         + 2 * (TI + 1))
    return TJ, TI, -(-Mj // TJ) * -(-Li // TI), smem


def covers(cfg) -> bool:
    m = cfg.mixing
    return (m.mix_geo_ts and not m.mix_iso_ts and not cfg.bc.ns_periodic
            and (any(m.tnu2) or any(m.tnu4)))


def slopes(cfg, grid, z_r):
    """Geopotential slopes (dZdx, dZde) of the s-surfaces at U and V
    points (t3dmix2_geo.h:150-170)."""
    pm_u = 0.5 * (grid.pm + st.im1(grid.pm)) * grid.umask
    pn_v = 0.5 * (grid.pn + st.jm1(grid.pn)) * grid.vmask
    dZdx = pm_u * (z_r - st.im1(z_r))
    dZde = pn_v * (z_r - st.jm1(z_r))
    if cfg.bc.ew_periodic:
        dZdx = st.periodic_x(dZdx)
    if cfg.bc.ns_periodic:
        dZde = st.periodic_y(dZde)
    return dZdx, dZde


def rot_div_geo_plain(cfg, grid, qs, d2s, Hz, z_r):
    """(NT, N, Mj, Li) rotated divergence of qs with the per-tracer
    coefficient planes d2s (NT, Mj, Li)."""
    from ..core.hmix import _rot_div_geo
    dZdx, dZde = slopes(cfg, grid, z_r)
    return torch.stack([_rot_div_geo(cfg, grid, q, d2, Hz, z_r, dZdx, dZde)
                        for q, d2 in zip(qs, d2s)])


def rot_div_geo(cfg, grid, qs, d2s, Hz, z_r):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors."""
    if qs.device.type == "cpu":
        return rot_div_geo_plain(cfg, grid, qs, d2s, Hz, z_r)
    return _launch(cfg, grid, qs, d2s, Hz, z_r)


def _launch(cfg, grid, qs, d2s, Hz, z_r):
    if not covers(cfg):
        raise NotImplementedError(
            "rot_div_geo kernel covers MIX_GEO_TS on grids that are not "
            "NS-periodic")
    NT, N, Mj, Li = qs.shape
    # the kernel builds the coefficient planes of core/hmix.py
    # _rot_div_geo from these
    ins, sfx, stream = _lib.prepare(
        "rot_div_geo", [qs, z_r, Hz, grid.pm, grid.pn, grid.umask,
                        grid.vmask, grid.on_u, grid.om_v, d2s])
    want = [(NT, N, Mj, Li), (N, Mj, Li), (N, Mj, Li)] + [(Mj, Li)] * 6 + [
        (NT, Mj, Li)]
    if [tuple(x.shape) for x in ins] != want or N < 2 or Mj < 3 or Li < 3:
        raise ValueError("rot_div_geo: inconsistent shapes")
    TJ, TI, _, _ = launch_shape(NT, Mj, Li, qs.element_size())
    out = torch.empty_like(ins[0])
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_rot_div_geo_{sfx}", [P] * 11 + [I] * 7 + [P])
    rc = fn(*[_lib.ptr(x) for x in ins + [out]], NT, N, Mj, Li,
            int(bool(cfg.bc.ew_periodic)), TJ, TI, P(stream))
    _lib.launches["rot_div_geo"] += 1
    _lib.check(rc, "rot_div_geo")
    return out


def rot_div_geo_single(cfg, grid, q, d2, Hz, z_r):
    """One tracer (roms_tpu's `rot_div_geo_pallas`): q (N, Mj, Li), d2 a
    number or an (Mj, Li) plane."""
    d2 = torch.as_tensor(d2, dtype=q.dtype, device=q.device) * \
        torch.ones_like(grid.pm)
    return rot_div_geo(cfg, grid, q[None], d2[None], Hz, z_r)[0]
