"""Lateral boundary conditions (port of roms_tpu/core/boundary.py:
the closed/gradient/clamped/periodic families; zetabc.F, u2dbc_im.F,
v2dbc_im.F, u3dbc_im.F, v3dbc_im.F, t3dbc_im.F).

Fields are [..., j, i] with the ring at j,i in {0, -1}.  For U-fields
the western boundary u-point is column 1; for V-fields the southern
boundary v-point is row 1.  The open families (radiation, Flather,
Chapman, ...) live in roms_tpu/core/obc.py and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

from ..config import LBC, PERIODIC, CLOSED, GRADIENT, CLAMPED
from ..ops import stencil as st

_KNOWN = (PERIODIC, CLOSED, GRADIENT, CLAMPED)


def _check(lbc: LBC):
    for side in ("west", "south", "east", "north"):
        if getattr(lbc, side) not in _KNOWN:
            raise NotImplementedError(
                f"open boundary '{getattr(lbc, side)}' ({side}): the "
                "obc module is ROADMAP Queue 1 item 6")


def _corners(f):
    """Ring corners from their two edge neighbours (bc_2d.F)."""
    f = f.clone()
    f[..., 0, 0] = 0.5 * (f[..., 1, 0] + f[..., 0, 1])
    f[..., 0, -1] = 0.5 * (f[..., 1, -1] + f[..., 0, -2])
    f[..., -1, 0] = 0.5 * (f[..., -2, 0] + f[..., -1, 1])
    f[..., -1, -1] = 0.5 * (f[..., -2, -1] + f[..., -1, -2])
    return f


def _apply_periodic(f, lbc: LBC):
    if lbc.west == PERIODIC:
        f = st.periodic_x(f)
    if lbc.south == PERIODIC:
        f = st.periodic_y(f)
    return f


def bc_rho(f, lbc: LBC, bdata: Optional[dict] = None):
    """BCs for a RHO-point field (zeta, tracers, W, rho)."""
    _check(lbc)
    bd = bdata or {}
    if lbc.west in (CLOSED, GRADIENT):
        f = st.set_col(f, 0, f[..., :, 1])
    elif lbc.west == CLAMPED:
        f = st.set_col(f, 0, bd.get("west", f[..., :, 1]))
    if lbc.east in (CLOSED, GRADIENT):
        f = st.set_col(f, -1, f[..., :, -2])
    elif lbc.east == CLAMPED:
        f = st.set_col(f, -1, bd.get("east", f[..., :, -2]))
    if lbc.south in (CLOSED, GRADIENT):
        f = st.set_row(f, 0, f[..., 1, :])
    elif lbc.south == CLAMPED:
        f = st.set_row(f, 0, bd.get("south", f[..., 1, :]))
    if lbc.north in (CLOSED, GRADIENT):
        f = st.set_row(f, -1, f[..., -2, :])
    elif lbc.north == CLAMPED:
        f = st.set_row(f, -1, bd.get("north", f[..., -2, :]))
    f = _apply_periodic(f, lbc)
    if lbc.west != PERIODIC and lbc.south != PERIODIC:
        f = _corners(f)
    return f


def bc_u(f, lbc: LBC, gamma2: float = 1.0, bdata: Optional[dict] = None):
    """BCs for a U-point field (ubar, u): closed W/E walls zero the
    wall u-point; closed S/N write gamma2 * interior into the ghost."""
    _check(lbc)
    bd = bdata or {}
    if lbc.west == CLOSED:
        f = st.set_col(st.set_col(f, 1, 0.0), 0, 0.0)
    elif lbc.west == GRADIENT:
        f = st.set_col(st.set_col(f, 1, f[..., :, 2]), 0, f[..., :, 2])
    elif lbc.west == CLAMPED:
        val = bd.get("west", f[..., :, 2])
        f = st.set_col(st.set_col(f, 1, val), 0, val)
    if lbc.east == CLOSED:
        f = st.set_col(f, -1, 0.0)
    elif lbc.east == GRADIENT:
        f = st.set_col(f, -1, f[..., :, -2])
    elif lbc.east == CLAMPED:
        f = st.set_col(f, -1, bd.get("east", f[..., :, -2]))
    if lbc.south == CLOSED:
        f = st.set_row(f, 0, gamma2 * f[..., 1, :])
    elif lbc.south == GRADIENT:
        f = st.set_row(f, 0, f[..., 1, :])
    elif lbc.south == CLAMPED:
        f = st.set_row(f, 0, bd.get("south", f[..., 1, :]))
    if lbc.north == CLOSED:
        f = st.set_row(f, -1, gamma2 * f[..., -2, :])
    elif lbc.north == GRADIENT:
        f = st.set_row(f, -1, f[..., -2, :])
    elif lbc.north == CLAMPED:
        f = st.set_row(f, -1, bd.get("north", f[..., -2, :]))
    f = _apply_periodic(f, lbc)
    if lbc.west != PERIODIC and lbc.south != PERIODIC:
        f = _corners(f)
    return f


def bc_v(f, lbc: LBC, gamma2: float = 1.0, bdata: Optional[dict] = None):
    """BCs for a V-point field (vbar, v) — mirror of bc_u."""
    _check(lbc)
    bd = bdata or {}
    if lbc.south == CLOSED:
        f = st.set_row(st.set_row(f, 1, 0.0), 0, 0.0)
    elif lbc.south == GRADIENT:
        f = st.set_row(st.set_row(f, 1, f[..., 2, :]), 0, f[..., 2, :])
    elif lbc.south == CLAMPED:
        val = bd.get("south", f[..., 2, :])
        f = st.set_row(st.set_row(f, 1, val), 0, val)
    if lbc.north == CLOSED:
        f = st.set_row(f, -1, 0.0)
    elif lbc.north == GRADIENT:
        f = st.set_row(f, -1, f[..., -2, :])
    elif lbc.north == CLAMPED:
        f = st.set_row(f, -1, bd.get("north", f[..., -2, :]))
    if lbc.west == CLOSED:
        f = st.set_col(f, 0, gamma2 * f[..., :, 1])
    elif lbc.west == GRADIENT:
        f = st.set_col(f, 0, f[..., :, 1])
    elif lbc.west == CLAMPED:
        f = st.set_col(f, 0, bd.get("west", f[..., :, 1]))
    if lbc.east == CLOSED:
        f = st.set_col(f, -1, gamma2 * f[..., :, -2])
    elif lbc.east == GRADIENT:
        f = st.set_col(f, -1, f[..., :, -2])
    elif lbc.east == CLAMPED:
        f = st.set_col(f, -1, bd.get("east", f[..., :, -2]))
    f = _apply_periodic(f, lbc)
    if lbc.west != PERIODIC and lbc.south != PERIODIC:
        f = _corners(f)
    return f
