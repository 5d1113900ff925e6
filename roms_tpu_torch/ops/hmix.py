"""Kernel 16: rotated (geopotential) triad divergence of every tracer
(csrc/hmix.cu).

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
    if not covers(cfg):
        raise NotImplementedError(
            "rot_div_geo kernel covers MIX_GEO_TS on grids that are not "
            "NS-periodic")
    NT, N, Mj, Li = qs.shape
    # coefficient planes, as core/hmix.py _rot_div_geo builds them
    pm_u = 0.5 * (grid.pm + st.im1(grid.pm)) * grid.umask
    pn_v = 0.5 * (grid.pn + st.jm1(grid.pn)) * grid.vmask
    pmn = grid.pm * grid.pn
    cff_u = 0.25 * (d2s + st.im1(d2s)) * grid.on_u
    cff_v = 0.25 * (d2s + st.jm1(d2s)) * grid.om_v
    ins, sfx, stream = _lib.prepare(
        "rot_div_geo", [qs, z_r, Hz, pm_u, pn_v, pmn, cff_u, cff_v, d2s])
    want = [(NT, N, Mj, Li), (N, Mj, Li), (N, Mj, Li)] + [(Mj, Li)] * 3 + [
        (NT, Mj, Li)] * 3
    if [tuple(x.shape) for x in ins] != want or N < 2 or Mj < 3 or Li < 3:
        raise ValueError("rot_div_geo: inconsistent shapes")
    out = torch.empty_like(ins[0])
    P, I = _lib.P, _lib.I
    fn = _lib.func(f"roms_rot_div_geo_{sfx}", [P] * 10 + [I] * 5 + [P])
    rc = fn(*[_lib.ptr(x) for x in ins + [out]], NT, N, Mj, Li,
            int(bool(cfg.bc.ew_periodic)), P(stream))
    _lib.launches["rot_div_geo"] += 1
    _lib.check(rc, "rot_div_geo")
    return out


def rot_div_geo_single(cfg, grid, q, d2, Hz, z_r):
    """One tracer (roms_tpu's `rot_div_geo_pallas`): q (N, Mj, Li), d2 a
    number or an (Mj, Li) plane."""
    d2 = torch.as_tensor(d2, dtype=q.dtype, device=q.device) * \
        torch.ones_like(grid.pm)
    return rot_div_geo(cfg, grid, q[None], d2[None], Hz, z_r)[0]
