"""Curvilinear Arakawa C-grid container (port of roms_tpu/grid/grid.py).

Layout as in the reference: 2-D fields are [eta, xi] = [j, i] with xi
innermost (contiguous), 3-D fields [k, j, i] with k=0 at the bottom,
and every stagger shares the full (Mm+2, Lm+2) shape including the
one-point boundary ring.

The metrics are assembled host-side in float64 numpy (ROMS/Utility/
metrics.F), then cast to `cfg.dtype` on the target device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device, torch_dtype
from . import scoord


class Grid:
    """Grid tensors on one device (same field names as roms_tpu)."""

    FIELDS = (
        "h", "pm", "pn", "f", "angler",
        "xr", "yr", "xu", "yu", "xv", "yv",
        "dndx", "dmde",
        "om_r", "on_r", "om_u", "on_u", "om_v", "on_v", "om_p", "on_p",
        "omn", "fomn",
        "pmon_r", "pnom_r", "pmon_p", "pnom_p", "pmon_u", "pnom_v",
        "rmask", "umask", "vmask", "pmask",
        "sc_r", "Cs_r", "sc_w", "Cs_w",
        "visc2_r", "visc2_p", "diff2",
        "visc4_r", "visc4_p", "diff4",
        "zice",
    )
    AUX = ("hc", "Lm", "Mm", "N", "spherical", "Vtransform")

    def __init__(self, **kw):
        for name in self.FIELDS + self.AUX:
            setattr(self, name, kw[name])

    @property
    def device(self) -> torch.device:
        return self.h.device

    @property
    def dtype(self) -> torch.dtype:
        return self.h.dtype


def _roll(a, shift, axis):
    return np.roll(a, shift, axis=axis)


def _avg_u(a):
    out = 0.5 * (a + _roll(a, 1, -1))
    out[..., 0] = a[..., 0]
    return out


def _avg_v(a):
    out = 0.5 * (a + _roll(a, 1, -2))
    out[..., 0, :] = a[..., 0, :]
    return out


def _avg_p(a):
    out = 0.25 * (a + _roll(a, 1, -1) + _roll(a, 1, -2)
                  + _roll(_roll(a, 1, -1), 1, -2))
    out[..., 0, :] = a[..., 0, :]
    out[..., :, 0] = a[..., :, 0]
    return out


def build_grid(cfg: ModelConfig, *, h, pm, pn, f,
               xr=None, yr=None, xu=None, yu=None, xv=None, yv=None,
               angler=None, rmask=None, dndx=None, dmde=None,
               spherical: bool = False, zice=None,
               device="cuda") -> Grid:
    """Assemble a Grid from rho-point primary fields (roms_tpu
    grid.build_grid semantics; zice must be None in this slice)."""
    if zice is not None:
        raise NotImplementedError(
            "ICESHELF grids (zice): ROADMAP Queue 1 item 8")
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    shp = cfg.shape2d

    def asf(x, default=None):
        if x is None:
            return np.full(shp, default, dtype=np.float64)
        return np.array(x, dtype=np.float64)

    h, pm, pn, f = asf(h), asf(pm), asf(pn), asf(f)
    angler = asf(angler, 0.0)
    xr, yr = asf(xr, 0.0), asf(yr, 0.0)
    xu, yu = asf(xu, 0.0), asf(yu, 0.0)
    xv, yv = asf(xv, 0.0), asf(yv, 0.0)
    rmask = asf(rmask, 1.0)

    umask = rmask * _roll(rmask, 1, -1)
    umask[..., 0] = rmask[..., 0]
    vmask = rmask * _roll(rmask, 1, -2)
    vmask[..., 0, :] = rmask[..., 0, :]
    pmask = (rmask * _roll(rmask, 1, -1) * _roll(rmask, 1, -2)
             * _roll(_roll(rmask, 1, -1), 1, -2))
    pmask[0, :] = 1.0
    pmask[:, 0] = 1.0

    om_r = 1.0 / pm
    on_r = 1.0 / pn
    omn = 1.0 / (pm * pn)
    fomn = f * omn
    pm_u, pn_u = _avg_u(pm), _avg_u(pn)
    pm_v, pn_v = _avg_v(pm), _avg_v(pn)
    pm_p, pn_p = _avg_p(pm), _avg_p(pn)

    if dndx is None:
        if cfg.curvgrid:
            inv_pn = 1.0 / pn
            inv_pm = 1.0 / pm
            dndx = 0.5 * (_roll(inv_pn, -1, -1) - _roll(inv_pn, 1, -1))
            dmde = 0.5 * (_roll(inv_pm, -1, -2) - _roll(inv_pm, 1, -2))
            dndx[..., 0] = 0.0
            dndx[..., -1] = 0.0
            dmde[..., 0, :] = 0.0
            dmde[..., -1, :] = 0.0
        else:
            dndx = np.zeros(shp)
            dmde = np.zeros(shp)
    else:
        dndx, dmde = asf(dndx), asf(dmde)

    sc_r, Cs_r, sc_w, Cs_w = scoord.stretching(cfg.vert)
    hc = scoord.compute_hc(cfg.vert, float(np.min(h)))

    mix = cfg.mixing
    fields = dict(
        h=h, pm=pm, pn=pn, f=f, angler=angler,
        xr=xr, yr=yr, xu=xu, yu=yu, xv=xv, yv=yv,
        dndx=dndx, dmde=dmde,
        om_r=om_r, on_r=on_r, om_u=1.0 / pm_u, on_u=1.0 / pn_u,
        om_v=1.0 / pm_v, on_v=1.0 / pn_v, om_p=1.0 / pm_p,
        on_p=1.0 / pn_p, omn=omn, fomn=fomn,
        pmon_r=pm / pn, pnom_r=pn / pm, pmon_p=pm_p / pn_p,
        pnom_p=pn_p / pm_p, pmon_u=pm_u / pn_u, pnom_v=pn_v / pm_v,
        rmask=rmask, umask=umask, vmask=vmask, pmask=pmask,
        sc_r=sc_r, Cs_r=Cs_r, sc_w=sc_w, Cs_w=Cs_w,
        visc2_r=np.full(shp, mix.visc2), visc2_p=np.full(shp, mix.visc2),
        diff2=np.stack([np.full(shp, t) for t in mix.tnu2]),
        visc4_r=np.full(shp, mix.visc4 ** 0.5),
        visc4_p=np.full(shp, mix.visc4 ** 0.5),
        diff4=np.stack([np.full(shp, t ** 0.5) for t in mix.tnu4]),
    )
    tensors = {k: torch.as_tensor(np.asarray(v, np.float64)).to(
        device=dev, dtype=dtype) for k, v in fields.items()}
    return Grid(**tensors, zice=None, hc=hc, Lm=cfg.Lm, Mm=cfg.Mm,
                N=cfg.N, spherical=spherical,
                Vtransform=cfg.vert.Vtransform)
