"""Kernel 12 of roms_tpu_torch, the j-blocked fast loop, against roms_tpu
on the CPU: float64, seeded zonally varying inputs on a small UPWELLING
grid.

- the port's `fast_loop_blocked` on CPU tensors (its plain version, the
  substep loop) against roms_tpu's `fast_loop_pallas` in interpret mode,
  at Mj = 23 (one full 16-row block and one ragged block) and nfast = 9
  (four KS = 2 chunks and one KS = 1 chunk), without 2D advection, whose
  VFx fault in the Pallas kernels is pinned in test_torch_upwelling.py;
  and against roms_tpu's jnp substep loop over whole arrays;
- the chunk schedule and the launch shape the CUDA wrapper takes;
- the engine switch of `make_fast_loop` and `Model`.

The CUDA kernel itself needs a card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from roms_tpu.core.rho_eos import rho_eos
from roms_tpu.core.step2d import make_substep_kernels
from roms_tpu.core.weights import power_law_weights
from roms_tpu.functionals import upwelling as up
from roms_tpu.grid.depth import set_depth
from roms_tpu.ops import pallas_step2d, stencil as st
from roms_tpu_torch.core import step2d as tcore_step2d
from roms_tpu_torch.core.stepping import Model
from roms_tpu_torch.functionals import upwelling as tup
from roms_tpu_torch.ops import _lib, step2d as tstep2d

from torch_port_util import port, rel_err

NAMES = ("zeta", "zeta_prev", "ubar", "ubar_prev", "vbar", "vbar_prev",
         "rzeta_prev", "rubar_prev", "rvbar_prev", "rufrc", "rvfrc", "Zt",
         "DU1", "DV1", "DU2", "DV2")
# Rows of the Pallas engine's output that it leaves dead (the edge clamp
# of its first block's minus block, pallas_step2d.py:553-561, and the
# padding of its ragged last block): the ring rows of the predictor rhs
# histories and the 2D forcing, which the next substep's BCs overwrite.
# The prognostic fields and the averages but DV_avg2 hold the jnp path's
# values everywhere.
PALLAS_LIVE_ROWS = {"rzeta_prev": np.s_[:-1], "rubar_prev": np.s_[1:-1],
                    "rufrc": np.s_[1:-1], "rvbar_prev": np.s_[2:-1],
                    "rvfrc": np.s_[2:-1], "DV2": np.s_[1:]}


@pytest.fixture(scope="module")
def case():
    """UPWELLING Lm=12, Mm=21 (Mj = 23), ndtfast = 6 (nfast = 9), no 2D
    advection, with seeded zonally varying fast-loop inputs whose
    periodic lanes hold their copies; the inputs as JAX arrays plus the
    config/grid of both packages."""
    torch.set_num_threads(1)
    cfg = up.make_config(Lm=12, Mm=21, N=6, dtype="float64").replace(
        dt=60.0, ndtfast=6, uv_adv=False)
    grid = up.make_grid(cfg)
    s = up.make_initial(cfg, grid)
    rng = np.random.default_rng(2026)
    N, (Mj, Li), NT = cfg.N, cfg.shape2d, cfg.NT

    def r(*shape, scale=1.0):
        return st.periodic_x(jnp.asarray(scale * rng.standard_normal(shape)))

    z_r, z_w, Hz = set_depth(grid, r(Mj, Li, scale=0.05))
    t = s.t + r(NT, N, Mj, Li, scale=0.1)
    _, _, rhoA, rhoS, _ = rho_eos(cfg, t, z_r, Hz, z_w)
    f2 = [r(Mj, Li, scale=1e-5) * grid.om_u * grid.on_u for _ in range(6)]
    dyn = [r(Mj, Li, scale=0.05), r(Mj, Li, scale=0.05) * grid.umask,
           r(Mj, Li, scale=0.05) * grid.vmask, f2[0], f2[1], rhoS, rhoA,
           f2[2], f2[3], f2[4], f2[5]]
    tcfg, tgrid = port(cfg, grid)
    nfast, w1, w2 = power_law_weights(cfg.ndtfast)
    got = tstep2d.fast_loop_blocked(
        tcfg, tgrid, nfast, w1, w2, True,
        *[torch.from_numpy(np.array(x)) for x in dyn], 5)
    return cfg, grid, dyn, (nfast, w1, w2), dict(zip(
        NAMES, tuple(got)[:11] + tuple(got.avg)))


def test_fast_loop_blocked_against_the_pallas_engine(case, monkeypatch):
    """The 16 carry fields against roms_tpu's j-blocked Pallas engine in
    interpret mode, over every row that engine keeps live."""
    monkeypatch.setenv("ROMS_TPU_PALLAS_STEP2D_INTERPRET", "1")
    cfg, grid, dyn, (nfast, w1, w2), got = case
    assert cfg.shape2d == (23, 14) and nfast == 9
    pal = pallas_step2d.fast_loop_pallas(
        cfg, grid, nfast, jnp.asarray(w1), jnp.asarray(w2), True, *dyn,
        jnp.asarray(5, jnp.int32))
    for name in NAMES:
        rows = PALLAS_LIVE_ROWS.get(name, np.s_[:])
        assert rel_err(pal[name], got[name], rows) < 1e-11, name


def test_fast_loop_blocked_against_the_jnp_loop(case):
    """The 16 carry fields over whole arrays, ring rows and lanes
    included, against roms_tpu's jnp substep loop (lax.scan of its
    predictor and corrector), the reference both Pallas engines follow."""
    cfg, grid, dyn, (nfast, w1, w2), got = case
    pred, corr, _, init = make_substep_kernels(
        cfg, nfast, jnp.asarray(w1), jnp.asarray(w2))
    iic = jnp.asarray(5, jnp.int32)

    def body(c, iif):
        zp, up_, vp, rz, ru, rv, rufc, rvfc, avg = pred(
            grid, iif, c, dyn[5], dyn[6], iic, dyn[9], dyn[10], None)
        c = corr(grid, iif, c._replace(avg=avg), zp, up_, vp, rz, ru, rv,
                 rufc, rvfc, dyn[5], dyn[6], None)
        return c, None

    c0 = init(dyn[0], dyn[1], dyn[2], dyn[3], dyn[4], dyn[7], dyn[8])
    ref, _ = lax.scan(body, c0, jnp.arange(1, nfast + 1, dtype=jnp.int32))
    for name, r in zip(NAMES, tuple(ref)[:11] + tuple(ref.avg)):
        assert rel_err(r, got[name]) < 1e-11, name


def test_chunk_schedule():
    """KS = 2 a launch and one KS = 1 launch for an odd remainder: 15
    launches a BENCHMARK3 step (ndtfast 20) and 21 an UPWELLING step
    (ndtfast 30)."""
    assert tstep2d.chunk_schedule(9) == [2, 2, 2, 2, 1]
    assert tstep2d.chunk_schedule(1) == [1]
    for ndtfast, nfast, launches in ((20, 29, 15), (30, 42, 21)):
        n = power_law_weights(ndtfast)[0]
        assert n == nfast
        assert len(tstep2d.chunk_schedule(n)) == launches
        assert sum(tstep2d.chunk_schedule(n)) == n


@pytest.mark.parametrize("shape", [(23, 14), (258, 2050), (1026, 514),
                                   (34, 66), (102, 205), (4, 4), (5, 4)])
def test_tiling_covers_the_grid(shape):
    """Kernel 12's launch shape per element size: the grid covered by as
    few tiles of at most TILE_BLOCKED[itemsize] as will do (float32 40 x
    56, float64 its own 16 x 40), the halo of 6 points a substep plus the
    BC copies' reach (two lanes more a substep and two more again on a
    grid of 4 or 5 lanes, where the periodic copies chain), and the KS = 2
    window's shared memory, itemsize x 10 planes x (TJ + 26) x (TI + 28)
    plus the row and lane tables at Li > 4, within a block's 227 KB; at
    the two full-width shapes float32 takes at most two rounds of 132
    resident blocks, and their scratch stays under 25 MB."""
    Mj, Li = shape
    narrow = Li <= 5
    assert tstep2d.halo(2, Li) == (13, 14 + 6 * narrow)
    assert tstep2d.halo(1, Li) == (7, 8 + 4 * narrow)
    for itemsize, tile in ((4, (40, 56)), (8, (16, 40))):
        assert tstep2d.TILE_BLOCKED[itemsize] == tile
        TJ, TI, HJ, HI, blocks, smem = tstep2d.blocked_launch_shape(
            Mj, Li, itemsize)
        assert TJ <= tile[0] and TI <= tile[1]
        nj, ni = -(-Mj // TJ), -(-Li // TI)
        assert nj == -(-Mj // tile[0]) and ni == -(-Li // tile[1])
        assert blocks == nj * ni and (HJ, HI) == tstep2d.halo(2, Li)
        WJ, WI = TJ + 2 * HJ, TI + 2 * HI
        assert smem == itemsize * tstep2d.BLOCKED_WIN_PLANES * WJ * WI \
            + 4 * (WJ + WI)
        if not narrow:
            assert smem == itemsize * 10 * (TJ + 26) * (TI + 28) \
                + 4 * (TJ + TI + 54)
        assert smem <= _lib.SMEM_PER_BLOCK
        if shape in ((258, 2050), (1026, 514)):
            assert itemsize == 8 or blocks <= 2 * 132
            scratch = min(blocks, 132) * tstep2d.blocked_scratch(
                TJ, TI, Li) * itemsize
            assert scratch <= 25e6, (itemsize, scratch)


@pytest.fixture(scope="module")
def tmodel_inputs():
    torch.set_num_threads(1)
    cfg = tup.make_config(Lm=10, Mm=12, N=4, dtype="float64")
    grid = tup.make_grid(cfg, device="cpu")
    return cfg, grid


def test_model_blocked_engine_equals_the_default_on_cpu(tmodel_inputs):
    """On the CPU both engines run the plain loop: two float64 steps of
    Model(fast_loop="blocked") equal the default Model's."""
    cfg, grid = tmodel_inputs
    runs = []
    for engine in ("resident", "blocked"):
        model = Model(cfg, grid, tup.make_forcing_fn(cfg, grid),
                      vmix_fn=tup.make_vmix_fn(cfg), fast_loop=engine)
        runs.append(model.run(tup.make_initial(cfg, grid), 2))
    for f in ("zeta", "ubar", "vbar", "u", "v", "t"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f


def test_unknown_engine_raises(tmodel_inputs):
    cfg, grid = tmodel_inputs
    with pytest.raises(ValueError, match="fast loop engine"):
        Model(cfg, grid, tup.make_forcing_fn(cfg, grid), fast_loop="scan")
    with pytest.raises(ValueError, match="fast loop engine"):
        tcore_step2d.fast_loop_kernel(cfg, "jnp", use_kernels=False)


def test_engine_takes_its_kernel_in_the_class_only(tmodel_inputs):
    """`fast_loop_kernel`: the engine's wrapper inside the channel class,
    the plain loop (None) outside it or without kernels."""
    from roms_tpu_torch.functionals import idealized as tia
    cfg, _ = tmodel_inputs
    fk = tcore_step2d.fast_loop_kernel
    assert fk(cfg, "resident") is tstep2d.fast_loop_res
    assert fk(cfg, "blocked") is tstep2d.fast_loop_blocked
    assert fk(cfg, "blocked", use_kernels=False) is None
    dg = tia.double_gyre_config(Lm=8, Mm=10, N=4)
    assert fk(dg, "resident") is None and fk(dg, "blocked") is None
