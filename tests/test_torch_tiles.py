"""Launch shapes of kernels 2 (tadv), 3 (rhs3d), 4 and 5 (uv_solve,
uv_finish), 6 (spline_vdiff), 7 and 8 (flux_omega, omega), 9 (prsgrd32), 10
(uv3dmix2_s), 11 (the resident fast loop), 14 and 15 (the KPP and prep
column), 16 (rot_div_geo) and 17 (tridiag) on the CPU: the tiles
cover the grid, kernel 11's halo, and the dynamic shared memory each
element size asks for against the H100's 227 KB a block and 228 KB an
SM.  The kernels themselves need the card: tests/test_torch_cuda.py."""

import pytest

from roms_tpu_torch.ops import (_lib, flux, hmix, kpp, prsgrd, rhs3d, step2d,
                                tadv, tridiag, uv, uvmix, vdiff)

# shared memory of one SM of the H100, 1 KB of it reserved per block
SMEM_PER_SM = 233472
SMS = 132          # the H100's streaming multiprocessors
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


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_rhs3d_launch_shape(shape, itemsize):
    """Kernel 3's tiles cover the grid with as few tiles of TILE as will
    do (at least five lanes, so that the shifted lane tiling keeps the
    periodic seam's ring positions in one tile), one point a thread; its
    window has a two-point halo and fits a block."""
    Mj, Li = shape
    TJ, TI, halo, blocks, smem = rhs3d.launch_shape(Mj, Li, itemsize)
    tile = rhs3d.TILE
    assert blocks == -(-Mj // TJ) * -(-Li // TI)
    assert TJ <= tile[0] and min(Li, 5) <= TI <= max(tile[1], 5)
    if TI >= 5:
        assert -(-Mj // TJ) == -(-Mj // tile[0])
        assert -(-Li // TI) == -(-Li // tile[1])
    assert TJ * TI <= rhs3d.THREADS and halo == 2
    WJ, WI = TJ + 2 * halo, TI + 2 * halo
    assert smem == itemsize * rhs3d.WINDOW_PLANES * WJ * WI \
        + 4 * (3 * WJ + 4 * WI)
    assert smem <= _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", FULL)
def test_rhs3d_fills_the_card(shape, itemsize):
    """At both full-width shapes kernel 3 launches more than one full wave
    of two blocks an SM, and two windows fit an SM's shared memory, in
    float32 and float64."""
    *_, blocks, smem = rhs3d.launch_shape(*shape, itemsize)
    assert blocks >= 2 * SMS
    assert 2 * (smem + 1024) <= SMEM_PER_SM


def test_rhs3d_tile_over_shared_memory_is_counted(monkeypatch):
    """A float64 tile whose window exceeds a block's 227 KB shows in the
    launch shape (the wrapper raises on it before launching)."""
    monkeypatch.setattr(rhs3d, "TILE", (64, 128))
    assert rhs3d.launch_shape(258, 2050, 8)[4] > _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", [3, 4, 16, 30, 64])
def test_uv_solve_launch_shape(N, itemsize):
    """Kernel 4's uv_solve: two blocks (u and v) per range of columns,
    4 N - 2 values a thread in shared memory, within a block's 227 KB up
    to 64 levels in either type."""
    for Mj, Li in SHAPES:
        B, blocks, smem = uv.solve_launch_shape(N, Mj, Li, itemsize)
        assert B == uv.SOLVE_THREADS[itemsize] and B % 32 == 0
        assert blocks == 2 * -(-(Mj * Li) // B)
        assert smem == itemsize * (4 * N - 2) * B
        assert smem <= _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape,N", [(FULL[0], 30), (FULL[1], 16)])
def test_uv_solve_fills_the_card_in_float32(shape, N):
    """At both full-width shapes and depths the float32 sweep launches
    many waves, and at least two blocks fit an SM's shared memory."""
    B, blocks, smem = uv.solve_launch_shape(N, *shape, 4)
    assert blocks >= 10 * SMS
    assert 2 * (smem + 1024) <= SMEM_PER_SM


def test_uv_solve_deep_float64_column_exceeds_shared_memory():
    """120 float64 levels need more than a block's 227 KB (the wrapper
    raises on it before launching)."""
    assert uv.solve_launch_shape(120, 23, 14, 8)[2] > _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("NT", [1, 2, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_tadv_launch_shape(shape, NT, itemsize):
    """Kernel 2's tiles cover the grid with as few tiles of TILE as will
    do (at least five lanes, for the shifted lane tiling's seam), one
    point a thread, one block a tile and group of up to GROUP tracers;
    its window has a two-point halo and fits a block at one, two and five
    tracers in either type."""
    Mj, Li = shape
    TJ, TI, halo, blocks, smem = tadv.launch_shape(NT, Mj, Li, itemsize)
    tile = tadv.TILE
    assert blocks == -(-Mj // TJ) * -(-Li // TI) * -(-NT // tadv.GROUP)
    assert TJ <= tile[0] and min(Li, 5) <= TI <= max(tile[1], 5)
    if TI >= 5:
        assert -(-Mj // TJ) == -(-Mj // tile[0])
        assert -(-Li // TI) == -(-Li // tile[1])
    assert TJ * TI <= tadv.THREADS and halo == 2
    G = min(NT, tadv.GROUP)
    WJ, WI = TJ + 2 * halo, TI + 2 * halo
    S = tadv.STAGES
    assert smem == itemsize * ((S * (G + 2) + 2 + 2 * G) * WJ * WI
                               + S * (G + 2) * tadv.THREADS) \
        + 4 * (WJ + 2 * WI + WJ * WI + (TJ + 1) * (TI + 1))
    assert smem <= _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", FULL)
def test_tadv_fills_the_card_in_float32(shape):
    """At both full-width shapes and the apps' two tracers kernel 2
    launches more than one full wave of the four blocks an SM its
    registers allow, four windows fit an SM's shared memory, and each
    face of a tile and its rim has a thread of its own."""
    TJ, TI, _, blocks, smem = tadv.launch_shape(2, *shape, 4)
    assert blocks >= 4 * SMS
    assert 4 * (smem + 1024) <= SMEM_PER_SM
    assert (TJ + 1) * (TI + 1) <= tadv.THREADS


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] >= 4])
def test_prsgrd_launch_shape(shape, itemsize):
    """Kernel 9's tiles cover the grid with as few tiles of TILE as will
    do (at least five lanes); the tile grown by its west lane and south
    row has a thread a column; its window reaches two rows and lanes
    south/west and one north/east and fits a block."""
    Mj, Li = shape
    TJ, TI, halo, blocks, smem = prsgrd.launch_shape(Mj, Li, itemsize)
    tile = prsgrd.TILE
    assert blocks == -(-Mj // TJ) * -(-Li // TI)
    assert TJ <= tile[0] and min(Li, 5) <= TI <= max(tile[1], 5)
    if TI >= 5:
        assert -(-Mj // TJ) == -(-Mj // tile[0])
        assert -(-Li // TI) == -(-Li // tile[1])
    assert (TJ + 1) * (TI + 1) <= prsgrd.THREADS and halo == (2, 1)
    WJ, WI = TJ + 3, TI + 3
    assert smem == itemsize * prsgrd.WINDOW_PLANES * WJ * WI \
        + 4 * (WJ + 3 * WI + WJ * WI)
    assert smem <= _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", FULL)
def test_prsgrd_fills_the_card_in_float32(shape):
    """At both full-width shapes kernel 9 launches more than one full
    wave of four blocks an SM (its registers' limit in float32), and four
    windows fit an SM's shared memory."""
    *_, blocks, smem = prsgrd.launch_shape(*shape, 4)
    assert blocks >= 4 * SMS
    assert 4 * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("mod", [tadv, prsgrd])
def test_tadv_prsgrd_tile_over_shared_memory_is_counted(mod, monkeypatch):
    """A float64 tile whose window exceeds a block's 227 KB shows in the
    launch shape (the wrappers raise on it before launching)."""
    monkeypatch.setattr(mod, "TILE", (64, 128))
    shape = mod.launch_shape(*((2,) if mod is tadv else ()), 258, 2050, 8)
    assert shape[4] > _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", [2, 16, 30, 64])
def test_prep_launch_shape(N, itemsize):
    """Kernels 14 and 15: one thread a column, its state in shared memory
    (the interior bvf (N-1), the Thomas cp (N-2) and the three spline
    derivatives (N-1 each)) with a stride of one more than the block's
    threads, within a block's 227 KB up to 64 levels in either type."""
    state = (N - 1) + (N - 2) + 3 * (N - 1)
    assert kpp.column_values(N) == state
    for Mj, Li in SHAPES:
        B, blocks, smem = kpp.prep_launch_shape(N, Mj, Li, itemsize)
        assert B == kpp.PREP_THREADS[itemsize] and B % 32 == 0
        assert blocks == -(-(Mj * Li) // B)
        assert smem == itemsize * state * (B + 1)
        assert smem <= _lib.SMEM_PER_BLOCK


def test_prep_fills_the_card_in_float32():
    """At BENCHMARK3's shape and depth the float32 column sweep launches
    many waves, and at least two blocks fit an SM's shared memory."""
    B, blocks, smem = kpp.prep_launch_shape(30, *FULL[0], 4)
    assert blocks >= 10 * SMS
    assert 2 * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", [2, 16, 30, 64])
def test_spline_vdiff_launch_shape(N, itemsize):
    """Kernel 6: NT blocks (one a tracer) per range of columns, 4 N - 2
    values a thread in shared memory, within a block's 227 KB up to 64
    levels in either type."""
    for NT in (1, 2, 5):
        for Mj, Li in SHAPES:
            B, blocks, smem = vdiff.vdiff_launch_shape(N, NT, Mj, Li,
                                                       itemsize)
            assert B == vdiff.VDIFF_THREADS[itemsize] and B % 32 == 0
            assert blocks == NT * -(-(Mj * Li) // B)
            assert smem == itemsize * (4 * N - 2) * B
            assert smem <= _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape,N", [(FULL[0], 30), (FULL[1], 16)])
def test_spline_vdiff_fills_the_card_in_float32(shape, N):
    """At both full-width shapes and depths the float32 sweep of the two
    tracers launches many waves, and at least two blocks fit an SM's
    shared memory."""
    B, blocks, smem = vdiff.vdiff_launch_shape(N, 2, *shape, 4)
    assert blocks >= 10 * SMS
    assert 2 * (smem + 1024) <= SMEM_PER_SM


def test_column_sweeps_deep_float64_column_exceeds_shared_memory():
    """200 float64 levels need more than a block's 227 KB in both column
    sweeps (the wrappers raise on it before launching)."""
    assert vdiff.vdiff_launch_shape(200, 2, 23, 14, 8)[2] > \
        _lib.SMEM_PER_BLOCK
    assert kpp.prep_launch_shape(200, 23, 14, 8)[2] > _lib.SMEM_PER_BLOCK



def test_seam_tiles_hold_the_periodic_seam():
    """The tiled kernels' shared tiling (ops/_lib.py seam_tiles) covers the
    grid with as few tiles as will do, and the tile that the half-tile
    shift puts on the seam holds lanes Li-2, Li-1, 0 and 1."""
    for Mj, Li in [s for s in SHAPES if s[1] >= 4]:
        TJ, TI, blocks = _lib.seam_tiles(Mj, Li, (7, 31))
        assert blocks == -(-Mj // TJ) * -(-Li // TI)
        seam = {(i - TI // 2) % Li for i in range(min(TI, Li))}
        assert {Li - 2, Li - 1, 0, 1} <= seam, (Mj, Li)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_uv_finish_launch_shape(itemsize):
    """Kernel 5's uv_finish: two blocks (u and v) per range of columns,
    hz*scale and q (2 N values a thread) in shared memory, within a
    block's 227 KB up to 64 levels in either type."""
    for N in (1, 3, 16, 30, 64):
        for Mj, Li in SHAPES:
            B, blocks, smem = uv.finish_launch_shape(N, Mj, Li, itemsize)
            assert B == uv.FINISH_THREADS[itemsize] and B % 32 == 0
            assert blocks == 2 * -(-(Mj * Li) // B)
            assert smem == itemsize * 2 * N * B
            assert smem <= _lib.SMEM_PER_BLOCK


def test_uv_finish_fills_the_card_in_float32():
    """At both full-width shapes and depths the float32 sweep launches
    many waves, and at least two blocks fit an SM's shared memory."""
    for shape, N in [(FULL[0], 30), (FULL[1], 16)]:
        B, blocks, smem = uv.finish_launch_shape(N, *shape, 4)
        assert blocks >= 10 * SMS
        assert 2 * (smem + 1024) <= SMEM_PER_SM


def test_uv_finish_deep_float64_column_exceeds_shared_memory():
    """A float64 column of 228 levels or more needs more than a block's
    227 KB (the wrapper raises on it before launching); 227 fit."""
    assert uv.finish_launch_shape(227, 23, 14, 8)[2] <= _lib.SMEM_PER_BLOCK
    assert uv.finish_launch_shape(228, 23, 14, 8)[2] > _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [4, 8])
def test_uvmix_launch_shape(itemsize):
    """Kernel 10's tiles cover the grid with as few tiles of TILE as will
    do (at least five lanes); the tile grown by a row and a lane has a
    thread a position; its window has a one-point halo and fits a
    block."""
    tile = uvmix.TILE
    for Mj, Li in [s for s in SHAPES if s[1] >= 4]:
        TJ, TI, blocks, smem = uvmix.launch_shape(Mj, Li, itemsize)
        assert blocks == -(-Mj // TJ) * -(-Li // TI)
        assert TJ <= tile[0] and min(Li, 5) <= TI <= max(tile[1], 5)
        if TI >= 5:
            assert -(-Mj // TJ) == -(-Mj // tile[0])
            assert -(-Li // TI) == -(-Li // tile[1])
        assert (TJ + 1) * (TI + 1) <= uvmix.THREADS and uvmix.HALO == 1
        WJ, WI = TJ + 2, TI + 2
        assert smem == itemsize * uvmix.WINDOW_PLANES * WJ * WI \
            + 4 * (WJ + 2 * WI + WJ * WI)
        assert smem <= _lib.SMEM_PER_BLOCK


def test_uvmix_fills_the_card():
    """At both full-width shapes kernel 10 launches more than one full
    wave of four blocks an SM, and four windows fit an SM's shared memory,
    in float32 and float64."""
    for shape in FULL:
        for itemsize in (4, 8):
            *_, blocks, smem = uvmix.launch_shape(*shape, itemsize)
            assert blocks >= 4 * SMS
            assert 4 * (smem + 1024) <= SMEM_PER_SM


def test_uvmix_tile_over_shared_memory_is_counted(monkeypatch):
    """A float64 tile whose window exceeds a block's 227 KB shows in the
    launch shape (the wrapper raises on it before launching)."""
    monkeypatch.setattr(uvmix, "TILE", (64, 128))
    assert uvmix.launch_shape(258, 2050, 8)[3] > _lib.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [4, 8])
def test_flux_omega_launch_shape(itemsize):
    """Kernels 7 and 8 (flux_omega and omega, one kernel body): the tiles
    cover the grid with as few tiles of TILE as will do (at least five
    lanes) and the one the half-tile shift puts on the seam holds lanes
    Li-2 .. 1; the tile grown by a row north and a lane east has a thread
    a position; flux_omega's staged windows and omega's staged fluxes,
    with the running sums of levels 0..N-2, fit a block up to 64 levels,
    and at BENCHMARK3's and UPWELLING's depths six float32 blocks of
    either fit an SM; the shallowest depth over a block is counted (the
    wrapper raises on it): omega's at N = 129 in float64 and 263 in
    float32 on 7 x 31 tiles."""
    tile = flux.TILE
    for Mj, Li in [s for s in SHAPES if min(s) >= 4]:
        for N in (1, 2, 16, 30, 64):
            for with_flux in (True, False):
                TJ, TI, blocks, smem = flux.launch_shape(N, Mj, Li, itemsize,
                                                         with_flux)
                assert blocks == -(-Mj // TJ) * -(-Li // TI)
                assert TJ <= tile[0] and min(Li, 5) <= TI <= max(tile[1], 5)
                if TI >= 5:
                    assert -(-Mj // TJ) == -(-Mj // tile[0])
                    assert -(-Li // TI) == -(-Li // tile[1])
                seam = {(i - TI // 2) % Li for i in range(min(TI, Li))}
                assert {Li - 2, Li - 1, 0, 1} <= seam, (Mj, Li)
                assert (TJ + 1) * (TI + 1) <= flux.THREADS
                nU, nV = TJ * (TI + 1), (TJ + 1) * TI
                win = (TJ + 2) * (TI + 2) + nU + nV
                staged = flux.STAGES * win + nU + nV if with_flux else \
                    flux.STAGES * (nU + nV)
                assert smem == itemsize * (staged + (N - 1) * TJ * TI)
                assert smem <= _lib.SMEM_PER_BLOCK
    if itemsize == 4:
        for shape, N in [(FULL[0], 30), (FULL[1], 16)]:
            for with_flux in (True, False):
                *_, blocks, smem = flux.launch_shape(N, *shape, 4, with_flux)
                assert blocks >= 6 * SMS
                assert 6 * (smem + 1024) <= SMEM_PER_SM
    for with_flux, refused in ((True, None), (False, {8: 129, 4: 263})):
        N = 2
        while flux.launch_shape(N, *FULL[0], itemsize,
                                with_flux)[3] <= _lib.SMEM_PER_BLOCK:
            N += 1
        assert N > 64 and flux.launch_shape(
            N, *FULL[0], itemsize, with_flux)[3] > _lib.SMEM_PER_BLOCK
        if refused:
            assert N == refused[itemsize]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tridiag_launch_shape(itemsize):
    """Kernel 17: one thread a column, cp and dp (2 N values a thread) in
    shared memory; the block fits a block's 227 KB at every depth of the
    class (N = 1..128) in either type, in whole warps; at the closures'
    (15, 1026, 514) in float32 it launches full 256-thread blocks, many
    waves of them, and seven fit an SM."""
    for N in range(1, tridiag.NMAX + 1):
        for Mj, Li in SHAPES:
            B, blocks, smem = tridiag.launch_shape(N, Mj, Li, itemsize)
            assert 32 <= B <= tridiag.THREADS[itemsize] and B % 32 == 0
            assert blocks == -(-(Mj * Li) // B)
            assert smem == itemsize * 2 * N * B <= _lib.SMEM_PER_BLOCK
    if itemsize == 4:
        B, blocks, smem = tridiag.launch_shape(15, *FULL[1], 4)
        assert B == 256 and blocks >= 10 * SMS
        assert 7 * (smem + 1024) <= SMEM_PER_SM

