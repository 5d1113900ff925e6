"""Launch shapes of kernels 11 (the resident fast loop) and 16
(rot_div_geo) on the CPU: the tiles cover the grid, kernel 11's halo, and
the dynamic shared memory each element size asks for against the H100's
227 KB a block and 228 KB an SM.  The kernels themselves need the card:
tests/test_torch_cuda.py."""

import pytest

from roms_tpu_torch.ops import _lib, hmix, step2d

# shared memory of one SM of the H100, 1 KB of it reserved per block
SMEM_PER_SM = 233472
FULL = [(258, 2050), (1026, 514)]    # BENCHMARK3, UPWELLING (Mj, Li)
SHAPES = FULL + [(4, 4), (5, 4), (35, 75), (23, 14), (3, 3)]


def _covers(Mj, Li, TJ, TI, tile, blocks):
    assert TJ <= tile[0] and TI <= tile[1]
    assert blocks == -(-Mj // TJ) * -(-Li // TI)
    assert blocks == -(-Mj // tile[0]) * -(-Li // tile[1])


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", [s for s in SHAPES if min(s) >= 4])
def test_fast_loop_res_launch_shape(shape, itemsize):
    """Kernel 11's tiles cover the grid with as few tiles of TILE_RES as
    will do; the halo is 3 points a half-step plus the wall row and the
    periodic lanes (two lanes more on a 4-lane grid); the window planes
    and tables fit a block."""
    Mj, Li = shape
    TJ, TI, HJ, HI, blocks, smem = step2d.res_launch_shape(Mj, Li, itemsize)
    _covers(Mj, Li, TJ, TI, step2d.TILE_RES[itemsize], blocks)
    assert (HJ, HI) == (4, 7 if Li == 4 else 5)
    WJ, WI = TJ + 2 * HJ, TI + 2 * HI
    assert smem == itemsize * (step2d.WIN_PLANES * WJ * WI + 2 * TJ * TI) \
        + 4 * (WJ + WI)
    assert smem <= _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", FULL)
def test_fast_loop_res_fills_the_card_in_float32(shape):
    """At both full-width channel shapes the float32 grid is one wave of
    three blocks an SM (396 slots on 132 SMs), and three windows fit an
    SM's shared memory."""
    *_, blocks, smem = step2d.res_launch_shape(*shape, 4)
    assert 360 <= blocks <= 396
    assert 3 * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("NT", [1, 2, 3])
def test_rot_div_geo_launch_shape(NT, itemsize):
    """Kernel 16's tiles cover the grid; up to three tracers fit a block
    in either type, and BENCHMARK3's two float32 tracers fit four blocks
    an SM."""
    for Mj, Li in SHAPES:
        TJ, TI, blocks, smem = hmix.launch_shape(NT, Mj, Li, itemsize)
        _covers(Mj, Li, TJ, TI, hmix.TILE, blocks)
        assert smem <= _lib.SMEM_PER_BLOCK
    if NT == 2 and itemsize == 4:
        smem = hmix.launch_shape(NT, *FULL[0], itemsize)[3]
        assert 4 * (smem + 1024) <= SMEM_PER_SM
