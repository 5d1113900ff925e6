"""Whole-array stencil shifts (port of roms_tpu/ops/stencil.py).

Shifts are `torch.roll`, with exactly the wrap semantics of the
reference's `jnp.roll`: values that wrap across a non-periodic edge
land in the boundary ring, which the boundary module overwrites.

Naming: `im1(a)[j, i] == a[j, i-1]` etc.  Axis convention: xi = -1,
eta = -2.  Ring writes return a new tensor; inputs are never modified.
"""

from __future__ import annotations

import torch


def im1(a):
    return torch.roll(a, 1, dims=-1)


def ip1(a):
    return torch.roll(a, -1, dims=-1)


def jm1(a):
    return torch.roll(a, 1, dims=-2)


def jp1(a):
    return torch.roll(a, -1, dims=-2)


def im1jm1(a):
    return torch.roll(a, (1, 1), dims=(-2, -1))


def dx_m(a):
    """a[i] - a[i-1]."""
    return a - im1(a)


def dx_p(a):
    """a[i+1] - a[i]."""
    return ip1(a) - a


def dy_m(a):
    return a - jm1(a)


def dy_p(a):
    return jp1(a) - a


def avg_x(a):
    """0.5*(a[i-1] + a[i])."""
    return 0.5 * (a + im1(a))


def avg_y(a):
    return 0.5 * (a + jm1(a))


def lap_x(a):
    """a[i-1] - 2 a[i] + a[i+1]."""
    return im1(a) - 2.0 * a + ip1(a)


def lap_y(a):
    return jm1(a) - 2.0 * a + jp1(a)


def set_col(a, at, val):
    """Copy of `a` with column `at` (xi index) set to `val`."""
    a = a.clone()
    a[..., at] = val
    return a


def set_row(a, at, val):
    """Copy of `a` with row `at` (eta index) set to `val`."""
    a = a.clone()
    a[..., at, :] = val
    return a


def periodic_x(a):
    """EW ring refresh: field(0) = field(Lm), field(Lm+1) = field(1)."""
    a = set_col(a, 0, a[..., -2])
    return set_col(a, -1, a[..., 1])


def periodic_y(a):
    a = set_row(a, 0, a[..., -2, :])
    return set_row(a, -1, a[..., 1, :])


# One-sided clamps at closed edges for private stencil arrays
# (mirrors e.g. pre_step3d.F:415-427: FX(Istr-1,:)=FX(Istr,:)).

def clamp_west(a, col=1, at=0, src=None):
    return set_col(a, at, (a if src is None else src)[..., col])


def clamp_east(a, col=-2, at=-1, src=None):
    return set_col(a, at, (a if src is None else src)[..., col])


def zero_west(a, at=0):
    return set_col(a, at, 0.0)


def zero_east(a, at=-1):
    return set_col(a, at, 0.0)


def clamp_south(a, row=1, at=0, src=None):
    return set_row(a, at, (a if src is None else src)[..., row, :])


def clamp_north(a, row=-2, at=-1, src=None):
    return set_row(a, at, (a if src is None else src)[..., row, :])


def zero_south(a, at=0):
    return set_row(a, at, 0.0)


def zero_north(a, at=-1):
    return set_row(a, at, 0.0)
