"""The CUDA kernels of roms_tpu_torch against their plain PyTorch
versions on the card, float64 at the tolerance of chip_smoke.py, plus
the wrappers' device discipline.

Needs an NVIDIA card and nvcc; without one the kernel cases skip.  This
file imports no JAX, so on a machine with the card but without JAX it
runs as

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from roms_tpu_torch.functionals import idealized as tia  # noqa: E402
from roms_tpu_torch.ops import (  # noqa: E402
    _lib, flux, hmix, kpp, prep, prsgrd, rhs3d, step2d, tadv, uv, uvmix,
    vdiff)

# the seven closed-basin entry points on DOUBLE_GYRE, the twelve of the
# EW-periodic UPWELLING channel, the fourteen of the BENCHMARK full
# physics and KPP alone, the tridiagonal solve of the GLS channel, and
# the j-blocked fast loop on the UPWELLING and BENCHMARK channels
CASES = [("double_gyre", n) for n in cs.SLICE1] + [
    ("upwelling", n) for n in cs.SLICE2] + [
    ("benchmark", n) for n in cs.APPS["benchmark"]["entries"]
    + cs.APPS["benchmark"]["off_path"]] + [
    ("upwelling_gls", n) for n in cs.APPS["upwelling_gls"]["checked"]] + [
    (app, n) for app in cs.BLOCKED if cs.APPS[app]["kernel_sizes"]
    for n in cs.APPS[app]["checked"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel: needs an NVIDIA card")


@pytest.mark.parametrize("app,name", CASES)
def test_cuda_kernel_matches_plain(app, name):
    _need_card()
    env = cs.setup(torch, 30, 61, 8, "float64", app=app)
    before = _lib.launches[name]
    args, _ = cs.entry_inputs(torch, name, *env, 5)
    rel, _ = cs.compare(torch, name, args, "float64")
    assert rel <= cs.TOL_F64.get(name, cs.TOL["float64"]), (name, rel)
    # kernel 12 launches once per chunk of its substeps
    want = len(step2d.chunk_schedule(args[2])) \
        if name == "fast_loop_blocked" else 1
    assert _lib.launches[name] == before + want


def test_wrapper_on_cpu_tensors_takes_the_plain_version():
    """CPU tensors never reach the kernel library (no build, no count)."""
    cfg = tia.double_gyre_config(Lm=8, Mm=10, N=4)
    grid = tia.double_gyre_grid(cfg, device="cpu")
    s = tia.double_gyre_initial(cfg, grid)
    before = dict(_lib.launches)
    W = torch.zeros_like(s.z_w)
    out = tadv.corrector(cfg, grid, s.t, s.Hz * s.t, s.u, s.v, W, s.Hz)
    assert out.device.type == "cpu"
    assert _lib.launches == before


@pytest.mark.parametrize("app", ["upwelling_gls", "upwelling_my25"])
def test_closure_step_launches_the_solve_four_times(app):
    """A GLS or MY2.5 step on the card solves its four systems with the
    kernel, each within float64 1e-12 of the plain sweep; the plain
    step launches nothing."""
    _need_card()
    systems = cs.closure_systems(torch, app, 12, 14, 8, "float64")
    assert len(systems) == 4
    for args in systems:
        rel, _ = cs.compare(torch, "tridiag", args, "float64")
        assert rel <= cs.TOL["float64"], rel
    for kern, want in ((True, 4), (False, 0)):
        model, s = cs.make_model(torch, app, 12, 14, 8, "float64", kern,
                                 300.0, True)
        before = _lib.launches["tridiag"]
        model.step(s)
        assert _lib.launches["tridiag"] == before + want


@pytest.mark.parametrize("shape", [(129, 3, 4), (4, 2, 3, 4)])
def test_tridiag_wrapper_raises_outside_its_class(shape):
    """On CUDA tensors the tridiagonal wrapper launches its kernel or
    raises: deeper than 128 levels or stacked 4-D systems raise."""
    _need_card()
    from roms_tpu_torch.ops import tridiag
    x = torch.ones(shape, device="cuda", dtype=torch.float64)
    before = _lib.launches["tridiag"]
    with pytest.raises(ValueError, match="tridiag"):
        tridiag.tridiag_solve(x, x, x, x)
    assert _lib.launches["tridiag"] == before


def test_fast_loop_blocked_raises_outside_its_class():
    """On CUDA tensors kernel 12's wrapper launches or raises: the closed
    DOUBLE_GYRE basin is outside the channel class, so it raises and
    falls back neither to kernel 11 nor to the plain loop."""
    _need_card()
    env = cs.setup(torch, 12, 14, 4, "float64", app="double_gyre")
    args, _ = cs.entry_inputs(torch, "fast_loop_blocked", *env, 5)
    before = dict(_lib.launches)
    with pytest.raises(NotImplementedError, match="fast_loop_blocked"):
        step2d.fast_loop_blocked(*args)
    assert _lib.launches == before


def test_blocked_engine_step_launches_kernel_12_only():
    """One float64 UPWELLING step of Model(fast_loop="blocked") on the
    card launches kernel 12 once per chunk and kernel 11 never, and
    agrees with the resident engine's step."""
    _need_card()
    runs = []
    for app in ("upwelling_blocked", "upwelling"):
        model, s = cs.make_model(torch, app, 12, 14, 8, "float64", True,
                                 300.0, True)
        before = dict(_lib.launches)
        runs.append(model.step(s))
        n12 = _lib.launches["fast_loop_blocked"] - before["fast_loop_blocked"]
        n11 = _lib.launches["fast_loop_res"] - before["fast_loop_res"]
        blocked = app == "upwelling_blocked"
        assert n12 == (len(step2d.chunk_schedule(model.nfast)) if blocked
                       else 0)
        assert n11 == (0 if blocked else 1)
    for f in ("zeta", "ubar", "vbar", "u", "v", "t"):
        a, b = getattr(runs[0], f), getattr(runs[1], f)
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), f


# (Lm, Mm, N) of kernel 11's shape cases (Mj = Mm + 2, Li = Lm + 2):
# the smallest grid the wrapper takes, Mj = Li = 4, and grids whose Mj
# and Li are not multiples of either type's tile (ops/step2d.py TILE_RES)
FAST_LOOP_SHAPES = [("upwelling", (2, 2, 4)), ("upwelling", (73, 33, 4)),
                    ("benchmark", (45, 19, 4))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("app,shape", FAST_LOOP_SHAPES)
def test_fast_loop_res_at_ragged_and_minimal_shapes(app, shape, dtype):
    """Kernel 11 (one launch per half-step, tiles with halo in shared
    memory) against its plain loop, from the first substep (iic = 0) and
    a later one, where ragged last tiles and the periodic lanes and
    walls of a one-tile grid meet."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    for iic in (0, 5):
        args, _ = cs.entry_inputs(torch, "fast_loop_res", *env, iic)
        before = _lib.launches["fast_loop_res"]
        rel, _ = cs.compare(torch, "fast_loop_res", args, dtype)
        tol = cs.TOL_F64["fast_loop_res"] if dtype == "float64" \
            else cs.TOL["float32"]
        assert rel <= tol, (app, shape, dtype, iic, rel)
        assert _lib.launches["fast_loop_res"] == before + 1


def _blocked_bitwise(dtype, shapes):
    """Kernel 12 at `shapes` from iic 0, 1 and 5: bitwise equal to kernel
    11, within the fast loops' bound of its plain loop, one launch a
    chunk."""
    tol = cs.TOL_F64["fast_loop_blocked"] if dtype == "float64" \
        else cs.TOL["float32"]
    failures = len(cs.FAILURES)
    for label, args in cs.blocked_cases(torch, dtype, shapes):
        rel, _, same = cs.blocked_check(torch, args, dtype)
        assert same and rel <= tol, (label, rel)
    assert len(cs.FAILURES) == failures, cs.FAILURES[failures:]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fast_loop_res_bitwise_equals_kernel_12(dtype):
    """The two fast-loop engines evaluate one set of per-point formulas
    in the same order: every carry field is bitwise equal at a ragged
    shape, at the full-width BENCHMARK3 and UPWELLING planes and on a
    channel whose last row tile has one row, from iic 0, 1 and 5."""
    _need_card()
    _blocked_bitwise(dtype, [("upwelling", (73, 33))]
                     + cs.BLOCKED_SHAPES[:3])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("NT", [1, 3])
@pytest.mark.parametrize("shape", [(37, 19, 2), (1, 1, 2)])
def test_rot_div_geo_tracers_sides_and_shapes(shape, NT, closed, dtype):
    """Kernel 16 (column marching over shared-memory tiles, every tracer
    in one pass) against its plain version at one and three tracers, N =
    2, EW-periodic and closed sides, at a grid ragged against both
    types' tiles (Mj = 21, Li = 39) and at the smallest it takes (Mj =
    Li = 3)."""
    _need_card()
    from roms_tpu_torch.config import LBC, BoundaryConfig
    env = cs.setup(torch, *shape, dtype, app="benchmark")
    cfg, grid, t, d2, Hz, z_r = cs.entry_inputs(torch, "rot_div_geo", *env,
                                                5)[0]
    if closed:
        cfg = cfg.replace(bc=BoundaryConfig.uniform(LBC()))
    rnd = env[3]
    qs = torch.stack([t[n % 2] + 0.1 * rnd(*t.shape[1:]) for n in range(NT)])
    d2s = torch.stack([d2[n % 2] * (1.0 + 0.5 * n) for n in range(NT)])
    before = _lib.launches["rot_div_geo"]
    rel, _ = cs.compare(torch, "rot_div_geo", (cfg, grid, qs, d2s, Hz, z_r),
                        dtype)
    assert rel <= cs.TOL[dtype], (shape, NT, closed, dtype, rel)
    assert _lib.launches["rot_div_geo"] == before + 1


def test_rot_div_geo_raises_when_its_tile_exceeds_shared_memory():
    """A launch the card refuses (40 float64 tracers need more than a
    block's 227 KB of shared memory) raises through _lib.check."""
    _need_card()
    env = cs.setup(torch, 10, 8, 2, "float64", app="benchmark")
    cfg, grid, t, d2, Hz, z_r = cs.entry_inputs(torch, "rot_div_geo", *env,
                                                5)[0]
    qs, d2s = t[:1].repeat(40, 1, 1, 1), d2[:1].repeat(40, 1, 1)
    assert hmix.launch_shape(40, *t.shape[2:], 8)[3] > _lib.SMEM_PER_BLOCK
    with pytest.raises(RuntimeError, match="rot_div_geo"):
        hmix.rot_div_geo(cfg, grid, qs, d2s, Hz, z_r)


@pytest.mark.parametrize("Mj", [4, 5])
def test_fast_loop_blocked_on_a_4_lane_channel(Mj):
    """Kernel 12 on 4- and 5-lane channels (the periodic copies chain and
    its halo takes 2 KS + 2 lanes more), both types, 42
    substeps, from iic 0, 1 and 5: bitwise equal to kernel 11 and within
    the fast loops' bound of its plain loop."""
    _need_card()
    for dtype in ("float64", "float32"):
        _blocked_bitwise(dtype, [("upwelling", (Li - 2, Mj - 2))
                                 for Li in (4, 5)])


def _closed(cfg):
    from roms_tpu_torch.config import LBC, BoundaryConfig
    return cfg.replace(bc=BoundaryConfig.uniform(LBC()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("app,shape", cs.REDESIGN_SHAPES)
def test_rhs3d_at_ragged_and_minimal_shapes(app, shape, closed, dtype):
    """Kernel 3 (column marching over shared-memory tiles) against its
    plain version with the app's lanes (EW-periodic on the channels) and
    with closed walls, on ragged grids and at the wrapper's minimal depth
    N = 3."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    args, _ = cs.entry_inputs(torch, "rhs3d_momentum", *env, 5)
    if closed:
        args = (_closed(args[0]),) + args[1:]
    before = _lib.launches["rhs3d_momentum"]
    rel, _ = cs.compare(torch, "rhs3d_momentum", args, dtype)
    assert rel <= cs.TOL[dtype], (app, shape, closed, dtype, rel)
    assert _lib.launches["rhs3d_momentum"] == before + 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("app,shape", cs.REDESIGN_SHAPES)
def test_uv_solve_at_ragged_and_minimal_shapes(app, shape, closed, dtype):
    """Kernel 4's uv_solve (a column sweep with its state in shared
    memory) against its plain version at N = 3 and 4 and ragged grids,
    closed and EW-periodic, from iic 0, 1 and 5 (the AB3 seeds)."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    for iic in (0, 1, 5):
        args, _ = cs.entry_inputs(torch, "uv_solve", *env, iic)
        if closed:
            args = (_closed(args[0]),) + args[1:]
        before = _lib.launches["uv_solve"]
        rel, _ = cs.compare(torch, "uv_solve", args, dtype)
        assert rel <= cs.TOL[dtype], (app, shape, closed, dtype, iic, rel)
        assert _lib.launches["uv_solve"] == before + 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("app,shape", cs.REDESIGN_SHAPES)
def test_tadv_at_ragged_and_minimal_shapes(app, shape, closed, dtype):
    """Kernel 2 (column marching over shared-memory tiles, a block a tile
    and group of two tracers) against its plain versions, both modes, at
    one, two and five tracers, N = 3 and 4 and ragged grids, closed and
    EW-periodic, the predictor from iic 0, 1 and 5; one launch a call."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    for name in ("tadv_predictor", "tadv_corrector"):
        for iic in (0, 1, 5) if name == "tadv_predictor" else (5,):
            args, _ = cs.entry_inputs(torch, name, *env, iic)
            if closed:
                args = (_closed(args[0]),) + args[1:]
            for NT in cs.TADV_NT:
                before = _lib.launches[name]
                rel, _ = cs.compare(torch, name,
                                    cs.with_tracers(torch, args, NT), dtype)
                assert rel <= cs.TOL[dtype], (name, shape, closed, iic, NT,
                                              rel)
                assert _lib.launches[name] == before + 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("app,shape", cs.PRSGRD_SHAPES)
def test_prsgrd_at_ragged_and_minimal_shapes(app, shape, dtype):
    """Kernel 9 (each column's pressure once a level, each limited
    difference once, in shared memory) against its plain version on
    EW-periodic channels: ragged grids, Li = 4 and N = 2."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    args, _ = cs.entry_inputs(torch, "prsgrd32", *env, 5)
    before = _lib.launches["prsgrd32"]
    rel, _ = cs.compare(torch, "prsgrd32", args, dtype)
    assert rel <= cs.TOL[dtype], (app, shape, dtype, rel)
    assert _lib.launches["prsgrd32"] == before + 1


def test_tadv_wrapper_launches_its_kernel_alone():
    """The tadv wrapper runs no PyTorch operation on the card: a call is
    one device kernel, tadv_kernel (pm*pn is formed in the kernel)."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    env = cs.setup(torch, 37, 19, 4, "float32", app="upwelling")
    for name in ("tadv_predictor", "tadv_corrector"):
        args, _ = cs.entry_inputs(torch, name, *env, 5)
        kern = cs.entry_fns(name)[0]
        kern(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern(*args)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.count]
        assert len(rows) == 1 and "tadv_kernel<" in rows[0].key, [
            e.key for e in rows]
        assert rows[0].count == 1


def test_redesigned_kernels_raise_over_shared_memory(monkeypatch):
    """float64 launches whose shared memory would exceed a block's 227 KB
    raise before launching: uv_solve's sweep at 120 levels, and rhs3d,
    tadv and prsgrd with a (64, 128) tile."""
    _need_card()
    env = cs.setup(torch, 10, 8, 120, "float64", app="upwelling")
    args, _ = cs.entry_inputs(torch, "uv_solve", *env, 5)
    before = dict(_lib.launches)
    with pytest.raises(ValueError, match="uv_solve"):
        uv.uv_solve(*args)
    env = cs.setup(torch, 126, 62, 3, "float64", app="upwelling")
    args, _ = cs.entry_inputs(torch, "rhs3d_momentum", *env, 5)
    monkeypatch.setattr(rhs3d, "TILE", (64, 128))
    assert rhs3d.launch_shape(64, 128, 8)[4] > _lib.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="rhs3d_momentum"):
        rhs3d.rhs3d_momentum(*args)
    for mod, name, call, shape in (
            (tadv, "tadv_corrector", tadv.corrector, (2, 64, 128, 8)),
            (prsgrd, "prsgrd32", prsgrd.prsgrd32, (64, 128, 8))):
        args, _ = cs.entry_inputs(torch, name, *env, 5)
        monkeypatch.setattr(mod, "TILE", (64, 128))
        assert mod.launch_shape(*shape)[4] > _lib.SMEM_PER_BLOCK
        with pytest.raises(ValueError, match=name):
            call(*args)
    assert _lib.launches == before


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("app,shape", cs.COLUMN_SHAPES)
def test_prep_and_kpp_at_ragged_and_minimal_shapes(app, shape, closed,
                                                   dtype):
    """Kernels 15 and 14 (the column sweep with its state in shared
    memory) against their plain versions on ragged grids and down to N =
    2, closed and EW-periodic, a statically unstable column every other
    one: no boundary-layer column moved, both forcing regimes and columns
    with and without a crossing; one launch a call."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    for name, args in cs.column_cases(torch, env).items():
        if closed:
            args = (_closed(args[0]),) + args[1:]
        before = _lib.launches[name]
        rel, _ = cs.compare(torch, name, args, dtype)
        assert rel <= cs.TOL[dtype], (name, app, shape, closed, rel)
        assert _lib.launches[name] == before + 1
        failures = len(cs.FAILURES)
        cs.hsbl_check(torch, name, args, dtype, label="test", regimes=True)
        assert cs.FAILURES[failures:] == []


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("closed", [False, True])
@pytest.mark.parametrize("app,shape", cs.COLUMN_SHAPES)
def test_spline_vdiff_at_ragged_and_minimal_shapes(app, shape, closed,
                                                   dtype):
    """Kernel 6 (uv_solve's column sweep, one thread a tracer and column)
    bitwise equal to its plain version at one, two and five tracers with
    one or two Akt profiles, on ragged grids and down to N = 2, closed and
    EW-periodic; one launch a call."""
    _need_card()
    env = cs.setup(torch, *shape, dtype, app=app)
    args, _ = cs.entry_inputs(torch, "spline_vdiff", *env, 5)
    if closed:
        args = (_closed(args[0]),) + args[1:]
    for NT, NAT in cs.VDIFF_TRACERS:
        before = _lib.launches["spline_vdiff"]
        rel, _ = cs.compare(torch, "spline_vdiff",
                            cs.vdiff_tracers(torch, args, NT, NAT), dtype)
        assert rel == 0.0, (app, shape, closed, NT, NAT, rel)
        assert _lib.launches["spline_vdiff"] == before + 1


def test_prep_fused_writes_the_stacked_outputs():
    """On the card prep_fused's Akt and ghats come from the kernel stacked
    over the active tracers, equal to the plain route's torch.stack, and
    the prep wrapper is one device kernel (no PyTorch operation)."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    model, s = cs.make_model(torch, "benchmark", 20, 9, 6, "float64", True,
                             150.0, True)
    cfg, grid = model.cfg, model.grid
    from roms_tpu_torch.ops.prep import surface_rho
    forcing = model.forcing_fn(s.time, s.t[0][-1], s.t[1][-1],
                               surface_rho(cfg, s.t, s.z_r))
    call = (cfg, grid, s.t, s.u, s.v, s.Hz, s.z_r, s.z_w, forcing)
    got = prep.prep_fused(*call)
    ref = prep.prep_fused(*call, use_kernels=False)
    assert got[5].shape == (cfg.NAT, cfg.N + 1) + cfg.shape2d
    assert got[6].shape == ref[6].shape
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-12 * float(r.abs().max())
    env = cs.setup(torch, 37, 19, 4, "float32", app="benchmark")
    args, _ = cs.entry_inputs(torch, "prep", *env, 5)
    prep.prep(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prep.prep(*args)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.count]
    assert len(rows) == 1 and "kpp_kernel<" in rows[0].key, [
        e.key for e in rows]


def test_column_sweeps_raise_over_shared_memory():
    """float64 launches of the column sweeps whose state would exceed a
    block's 227 KB raise before launching, at the shallowest such depth."""
    _need_card()
    before = dict(_lib.launches)
    for name, smem_of, call in (
            ("spline_vdiff", lambda n: vdiff.vdiff_launch_shape(
                n, 2, 10, 12, 8)[2], vdiff.spline_vdiff),
            ("prep", lambda n: kpp.prep_launch_shape(n, 10, 12, 8)[2],
             prep.prep),
            ("kpp", lambda n: kpp.prep_launch_shape(n, 10, 12, 8)[2],
             kpp.kpp)):
        N = 2
        while smem_of(N) <= _lib.SMEM_PER_BLOCK:
            N += 1
        env = cs.setup(torch, 10, 8, N - 1, "float64", app="benchmark")
        args, _ = cs.entry_inputs(torch, name, *env, 5)
        call(*args)
        env = cs.setup(torch, 10, 8, N, "float64", app="benchmark")
        args, _ = cs.entry_inputs(torch, name, *env, 5)
        with pytest.raises(ValueError, match=name):
            call(*args)
        before[name] += 1
    assert _lib.launches == before



@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_uv_finish_at_ragged_and_minimal_shapes(dtype):
    """Kernel 5's uv_finish (uv_solve's column sweep, its state in shared
    memory) bitwise equal to its plain version at N = 3 and 4 and ragged
    grids, closed and EW-periodic (the periodic flux lanes); one launch a
    call."""
    _need_card()
    for app, shape in cs.REDESIGN_SHAPES:
        env = cs.setup(torch, *shape, dtype, app=app)
        args, _ = cs.entry_inputs(torch, "uv_finish", *env, 5)
        for closed in (False, True):
            if closed:
                args = (_closed(args[0]),) + args[1:]
            before = _lib.launches["uv_finish"]
            rel, _ = cs.compare(torch, "uv_finish", args, dtype)
            assert rel == 0.0, (app, shape, closed, dtype, rel)
            assert _lib.launches["uv_finish"] == before + 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_uvmix_at_ragged_and_minimal_shapes(dtype):
    """Kernel 10 (each stress formed once a level on a k-marching tile in
    shared memory) bitwise equal to its plain version on EW-periodic
    channels: ragged grids, Li = 4 and N = 2; one launch a call."""
    _need_card()
    for app, shape in cs.PRSGRD_SHAPES:
        env = cs.setup(torch, *shape, dtype, app=app)
        args, _ = cs.entry_inputs(torch, "uv3dmix2_s", *env, 5)
        before = _lib.launches["uv3dmix2_s"]
        rel, _ = cs.compare(torch, "uv3dmix2_s", args, dtype)
        assert rel == 0.0, (app, shape, dtype, rel)
        assert _lib.launches["uv3dmix2_s"] == before + 1


def test_uv_finish_and_uvmix_raise_over_shared_memory(monkeypatch):
    """float64 launches over a block's 227 KB raise before launching:
    uv_finish at the shallowest such depth (one level less launches), and
    uvmix with a (64, 128) tile."""
    _need_card()
    before = dict(_lib.launches)
    N = 2
    while uv.finish_launch_shape(N, 10, 12, 8)[2] <= _lib.SMEM_PER_BLOCK:
        N += 1
    env = cs.setup(torch, 10, 8, N - 1, "float64", app="upwelling")
    args, _ = cs.entry_inputs(torch, "uv_finish", *env, 5)
    uv.uv_finish(*args)
    env = cs.setup(torch, 10, 8, N, "float64", app="upwelling")
    args, _ = cs.entry_inputs(torch, "uv_finish", *env, 5)
    with pytest.raises(ValueError, match="uv_finish"):
        uv.uv_finish(*args)
    before["uv_finish"] += 1
    env = cs.setup(torch, 126, 62, 3, "float64", app="upwelling")
    args, _ = cs.entry_inputs(torch, "uv3dmix2_s", *env, 5)
    monkeypatch.setattr(uvmix, "TILE", (64, 128))
    with pytest.raises(ValueError, match="uv3dmix2_s"):
        uvmix.uv3dmix2_s(*args)
    assert _lib.launches == before


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flux_omega_and_tridiag_at_ragged_and_minimal_shapes(dtype):
    """Kernel 7 (each mass flux formed once a level on a k-marching tile,
    the running sums in shared memory) bitwise equal to its plain version
    on ragged, 4- and 5-lane channels, Mj = 4, N = 1 and 2 and a last row
    tile of one row; kernel 17 (cp and dp in shared memory) bitwise on
    seeded systems of 1 to 128 levels; one launch a call.  In float64 a
    flux_omega launch over a block's 227 KB raises before launching (one
    level less launches).  Kernel 8 (omega on flux_omega's k-marching
    tile) bitwise at FLUX_SHAPES, one launch a call, its float64 launch
    over 227 KB raising likewise; kernel 13 (the bulk fluxes and the
    staggered stresses in one C call) bitwise on planes of Mj = 4, 5 and
    43 (an odd Li) in both stability regimes, with cool skin, COARE 3.5
    and blk_zq other than blk_zt, one launch a call."""
    _need_card()
    for app, shape in cs.FLUX_SHAPES:
        env = cs.setup(torch, *shape, dtype, app=app)
        for name in ("flux_omega", "omega"):
            args, _ = cs.entry_inputs(torch, name, *env, 5)
            before = _lib.launches[name]
            rel, _ = cs.compare(torch, name, args, dtype)
            assert rel == 0.0, (name, app, shape, dtype, rel)
            assert _lib.launches[name] == before + 1
    for N in cs.TRIDIAG_DEPTHS:
        for Mj, Li in cs.TRIDIAG_PLANES:
            args = cs.tridiag_system(torch, N, Mj, Li, dtype)
            before = _lib.launches["tridiag"]
            rel, _ = cs.compare(torch, "tridiag", args, dtype)
            assert rel == 0.0, (N, Mj, Li, dtype, rel)
            assert _lib.launches["tridiag"] == before + 1
    if dtype == "float64":
        assert cs.flux_refused_depth(14, 31, with_flux=False) == 129
        for name, call in (("flux_omega", flux.flux_omega),
                           ("omega", flux.omega)):
            N = cs.flux_refused_depth(14, 31, name == "flux_omega")
            env = cs.setup(torch, 29, 12, N - 1, dtype, app="benchmark")
            args, _ = cs.entry_inputs(torch, name, *env, 5)
            call(*args)
            env = cs.setup(torch, 29, 12, N, dtype, app="benchmark")
            args, _ = cs.entry_inputs(torch, name, *env, 5)
            before = dict(_lib.launches)
            with pytest.raises(ValueError, match=name):
                call(*args)
            assert _lib.launches == before
    for label, args in cs.bulk_cases(torch, dtype, cs.BULK_PLANES[1:]):
        before = _lib.launches["bulk_flux"]
        rel, _ = cs.compare(torch, "bulk_flux", args, dtype)
        assert rel == 0.0, (label, dtype, rel)
        assert _lib.launches["bulk_flux"] == before + 1
