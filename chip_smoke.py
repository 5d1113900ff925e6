#!/usr/bin/env python3
"""GPU smoke test of roms_tpu_torch, the PyTorch/CUDA port of roms_tpu.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile  # only: where the full-width step's
                                     # time goes (CUDA events, profiler)

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card's name and power limit; build of the CUDA kernels from
     roms_tpu_torch/csrc (one nvcc per source, all started together);
  2. kernel phase: each of the seven kernel entry points against its
     plain PyTorch version on the card, same inputs, float64 (rel
     <= 1e-12) and float32 (rel <= 1e-5: FMA contraction and
     reassociation), at a moderate and at the full-width shape;
  3. slice parity: DOUBLE_GYRE Lm=64, Mm=128, N=10, float64, 5 steps,
     kernels vs `Model(use_kernels=False)`, within 1e-10*max|x| + 5e-14;
  4. full width: DOUBLE_GYRE Lm=512, Mm=1024, N=30 (15.7M rho points)
     in float32, dt=240 s, ndtfast=30, 10 steps after a warm-up step:
     finite fields, interior volume conserved, ms/step from CUDA events,
     no plain version called, each kernel's launches in that run and its
     time next to its plain version and its memory bound.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM float32, non-tensor
TOL = {"float64": 1e-12, "float32": 1e-5}
DEVICE = "cuda"
FAILURES = []       # kernel-vs-plain excesses, reported at phase end


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import roms_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"FAIL: roms_tpu_torch not importable: {exc}",
              file=sys.stderr)
        return 1
    from roms_tpu_torch.ops import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _lib.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_lib.build_seconds:.1f} s)", flush=True)
    print(_lib.ptxas_report(), flush=True)
    _lib.lib()

    if "--profile" in sys.argv[1:]:
        profile_step(torch)
        return 0
    kernel_phase_checks(torch)
    slice_parity(torch)
    table = full_width(torch)
    files = sorted({os.path.basename(src) for src, _ in SOURCES.values()})
    print(f"kernels: {files} ({len(files)} files, {len(table)} entry "
          f"points)", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# --------------------------------------------------------------------------
# kernel entry points on realistic inputs
# --------------------------------------------------------------------------

SOURCES = {
    "rho_eos": ("roms_tpu_torch/csrc/rho.cu",
                "roms_tpu/ops/pallas_rho.py:76"),
    "tadv_predictor": ("roms_tpu_torch/csrc/tadv.cu",
                       "roms_tpu/ops/pallas_tadv.py:294"),
    "tadv_corrector": ("roms_tpu_torch/csrc/tadv.cu",
                       "roms_tpu/ops/pallas_tadv.py:286"),
    "rhs3d_momentum": ("roms_tpu_torch/csrc/rhs3d.cu",
                       "roms_tpu/ops/pallas_rhs3d.py:349"),
    "uv_solve": ("roms_tpu_torch/csrc/uv.cu",
                 "roms_tpu/ops/pallas_uv.py:174"),
    "uv_finish": ("roms_tpu_torch/csrc/uv.cu",
                  "roms_tpu/ops/pallas_uv.py:214"),
    "spline_vdiff": ("roms_tpu_torch/csrc/vdiff.cu",
                     "roms_tpu/ops/pallas_vdiff.py:37"),
}

# flops per output point (per level for column kernels), counted from
# the kernels' arithmetic; only used for the operations bound
FLOPS_PER_POINT = {"rho_eos": 12, "tadv_predictor": 90,
                   "tadv_corrector": 80, "rhs3d_momentum": 220,
                   "uv_solve": 60, "uv_finish": 30, "spline_vdiff": 25}


def setup(torch, Lm, Mm, N, dtype, seed=7):
    """DOUBLE_GYRE config/grid/state at the given size with seeded
    perturbations, made on the card."""
    from roms_tpu_torch.functionals import idealized as ia
    from roms_tpu_torch.grid.depth import set_depth
    cfg = ia.double_gyre_config(Lm=Lm, Mm=Mm, N=N, dt=240.0, ndtfast=30,
                                dtype=dtype)
    grid = ia.double_gyre_grid(cfg, device=DEVICE)
    s = ia.double_gyre_initial(cfg, grid)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = grid.dtype

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE, dtype=tdt)

    zeta = 0.05 * rnd(*cfg.shape2d)
    z_r, z_w, Hz = set_depth(grid, zeta)
    return cfg, grid, s, rnd, z_r, z_w, Hz


def entry_inputs(torch, name, cfg, grid, s, rnd, z_r, z_w, Hz, iic):
    """(args, inputs-for-bytes) of one entry point."""
    from roms_tpu_torch.core.pre_step3d import tracer_predictor_coefs
    from roms_tpu_torch.core.step3d_uv import ab3_lead
    from roms_tpu_torch.core.omega import omega
    from roms_tpu_torch.grid.depth import set_massflux
    N = cfg.N
    shp3 = (N,) + cfg.shape2d
    t = s.t + 0.1 * rnd(*s.t.shape)
    u = 0.1 * rnd(*shp3) * grid.umask
    v = 0.1 * rnd(*shp3) * grid.vmask
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    W = omega(cfg, grid, Huon, Hvom, z_w)
    pmn = grid.pm * grid.pn
    if name == "rho_eos":
        args = (cfg, t, z_r, Hz, z_w)
        return args, [t, z_r, Hz, z_w]
    if name == "tadv_predictor":
        t_prev = t + 0.01 * rnd(*t.shape)
        args = (cfg, grid, t, t_prev, Huon, Hvom, W, Hz,
                *tracer_predictor_coefs(cfg, iic))
        return args, [t, t_prev, Huon, Hvom, W, Hz, pmn, grid.umask,
                      grid.vmask]
    if name == "tadv_corrector":
        t_part = Hz * t
        args = (cfg, grid, t, t_part, Huon, Hvom, W, Hz)
        return args, [t, t_part, Huon, Hvom, W, pmn, grid.umask,
                      grid.vmask]
    if name == "rhs3d_momentum":
        ru, rv = rnd(*shp3), rnd(*shp3)
        args = (cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv)
        return args, [u, v, Hz, Huon, Hvom, W, ru, rv, grid.fomn]
    Akv = 1e-3 * torch.abs(rnd(N + 1, *cfg.shape2d)) + 1e-5
    D = torch.sum(Hz, dim=0)
    if name == "uv_solve":
        u_part, v_part = u * Hz, v * Hz
        ru, rv = 1e-2 * rnd(*shp3), 1e-2 * rnd(*shp3)
        DU1 = 0.01 * rnd(*cfg.shape2d) * D * grid.on_u
        DV1 = 0.01 * rnd(*cfg.shape2d) * D * grid.om_v
        args = (cfg, grid, u_part, v_part, ru, rv, Hz, Akv,
                ab3_lead(cfg, iic), DU1, DV1)
        return args, [u_part, v_part, ru, rv, Hz, Akv, grid.pm, grid.pn,
                      grid.umask, grid.vmask, grid.on_u, grid.om_v, DU1,
                      DV1]
    if name == "uv_finish":
        DU = [0.01 * rnd(*cfg.shape2d) * D * m
              for m in (grid.on_u, grid.om_v, grid.on_u, grid.om_v)]
        args = (cfg, grid, u, v, Hz, Huon, Hvom, *DU)
        return args, [u, v, Hz, Huon, Hvom, grid.umask, grid.vmask,
                      grid.on_u, grid.om_v, *DU]
    if name == "spline_vdiff":
        Akt = 1e-3 * torch.abs(rnd(cfg.NAT, N + 1, *cfg.shape2d)) + 1e-6
        pre = Hz * t
        return (cfg, pre, Hz, Akt), [pre, Hz, Akt]
    raise KeyError(name)


def entry_fns(name):
    from roms_tpu_torch.ops import rho, rhs3d, tadv, uv, vdiff
    return {
        "rho_eos": (rho.rho_eos, rho.rho_eos_plain),
        "tadv_predictor": (tadv.predictor, tadv.predictor_plain),
        "tadv_corrector": (tadv.corrector, tadv.corrector_plain),
        "rhs3d_momentum": (rhs3d.rhs3d_momentum,
                           rhs3d.rhs3d_momentum_plain),
        "uv_solve": (uv.uv_solve, uv.uv_solve_plain),
        "uv_finish": (uv.uv_finish, uv.uv_finish_plain),
        "spline_vdiff": (vdiff.spline_vdiff, vdiff.spline_vdiff_plain),
    }[name]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare(torch, name, args, dtype):
    """Kernel vs plain on the same inputs; returns (max rel, max abs)."""
    kern, plain = entry_fns(name)
    got = as_tuple(kern(*args))
    ref = as_tuple(plain(*args))
    torch.cuda.synchronize()
    rel = abs_err = 0.0
    for g, r in zip(got, ref):
        if not torch.isfinite(g).all():
            fail(f"{name} {dtype}: non-finite kernel output")
        d = float((g - r).abs().max())
        scale = float(r.abs().max()) + 1e-300
        rel = max(rel, d / scale)
        abs_err = max(abs_err, d)
    if rel > TOL[dtype]:
        FAILURES.append(f"{name} {dtype}: rel err {rel:.3e} > "
                        f"{TOL[dtype]:.0e}")
    return rel, abs_err


def kernel_phase_checks(torch):
    from roms_tpu_torch.ops import _lib
    for (Lm, Mm, N) in ((128, 256, 30), (512, 1024, 30)):
        for dtype in ("float64", "float32"):
            env = setup(torch, Lm, Mm, N, dtype)
            for name in SOURCES:
                iics = (0, 1, 5) if name in ("tadv_predictor",
                                             "uv_solve") else (5,)
                for iic in iics:
                    args, _ = entry_inputs(torch, name, *env, iic)
                    rel, abs_err = compare(torch, name, args, dtype)
                    print(f"kernel {name:15s} {dtype} N={N} Mj={Mm + 2} "
                          f"Li={Lm + 2} iic={iic}: max rel {rel:.3e} "
                          f"max abs {abs_err:.3e}", flush=True)
            # the rho kernel's JM95 branch (off the DOUBLE_GYRE path)
            args, _ = entry_inputs(torch, "rho_eos", *env, 5)
            cfg = args[0]
            args = (cfg.replace(eos=cfg.eos.__class__(linear=False)),
                    *args[1:])
            rel, abs_err = compare(torch, "rho_eos", args, dtype)
            print(f"kernel rho_eos JM95     {dtype} N={N} Mj={Mm + 2} "
                  f"Li={Lm + 2}: max rel {rel:.3e} max abs {abs_err:.3e}",
                  flush=True)
            del env
            torch.cuda.empty_cache()
    if FAILURES:
        fail("kernel phase:\n  " + "\n  ".join(FAILURES))
    _lib.reset_launches()


# --------------------------------------------------------------------------
# slice parity and full width
# --------------------------------------------------------------------------

def run_model(torch, Lm, Mm, N, dtype, nsteps, use_kernels, dt, ndtfast):
    from roms_tpu_torch.core.stepping import Model
    from roms_tpu_torch.functionals import idealized as ia
    cfg = ia.double_gyre_config(Lm=Lm, Mm=Mm, N=N, dt=dt,
                                ndtfast=ndtfast, dtype=dtype)
    grid = ia.double_gyre_grid(cfg, device=DEVICE)
    s = ia.double_gyre_initial(cfg, grid)
    model = Model(cfg, grid, ia.double_gyre_forcing_fn(cfg, grid),
                  use_kernels=use_kernels)
    return model, model.run(s, nsteps)


def slice_parity(torch):
    from roms_tpu_torch.ops import _lib
    _, a = run_model(torch, 64, 128, 10, "float64", 5, False, 1800.0, 30)
    counts = dict(_lib.launches)
    if any(counts.values()):
        fail(f"use_kernels=False launched kernels: {counts}")
    _, b = run_model(torch, 64, 128, 10, "float64", 5, True, 1800.0, 30)
    for f in ("zeta", "ubar", "vbar", "u", "v", "t"):
        x, y = getattr(a, f), getattr(b, f)
        if not torch.isfinite(y).all():
            fail(f"slice parity: {f} not finite")
        d = float((x - y).abs().max())
        scale = float(x.abs().max())
        print(f"slice parity {f:5s}: max|diff| {d:.3e}  max|x| {scale:.3e}",
              flush=True)
        if d >= 1e-10 * scale + 5e-14:
            fail(f"slice parity {f}: {d:.3e} vs {scale:.3e}")
    _lib.reset_launches()


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


def plain_calls_during(run):
    """run() while every plain version records its calls; returns
    (run's result, sorted names of the plain versions that ran)."""
    calls = set()
    patched = []
    for name in SOURCES:
        plain = entry_fns(name)[1]
        mod = sys.modules[plain.__module__]

        def spy(*args, _name=name, _fn=plain):
            calls.add(_name)
            return _fn(*args)
        patched.append((mod, plain.__name__, plain))
        setattr(mod, plain.__name__, spy)
    try:
        return run(), sorted(calls)
    finally:
        for mod, attr, plain in patched:
            setattr(mod, attr, plain)


def full_width(torch):
    from roms_tpu_torch.core.stepping import Model
    from roms_tpu_torch.functionals import idealized as ia
    from roms_tpu_torch.ops import _lib
    Lm, Mm, N, nsteps = 512, 1024, 30, 10
    cfg = ia.double_gyre_config(Lm=Lm, Mm=Mm, N=N, dt=240.0, ndtfast=30,
                                dtype="float32")
    grid = ia.double_gyre_grid(cfg, device=DEVICE)
    s = ia.double_gyre_initial(cfg, grid)
    model = Model(cfg, grid, ia.double_gyre_forcing_fn(cfg, grid))
    s = model.step(s)                      # warm-up step
    torch.cuda.synchronize()

    _lib.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    s, plain_calls = plain_calls_during(lambda: model.run(s, nsteps))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_lib.launches)
    if plain_calls:
        fail(f"plain versions ran on the main path: {plain_calls}")
    ms_step = start.elapsed_time(end) / nsteps
    print(f"full width DOUBLE_GYRE {Mm + 2}x{Lm + 2}x{N} float32: "
          f"{ms_step:.3f} ms/step (CUDA events), host wall "
          f"{1e3 * wall / nsteps:.3f} ms/step, nfast={model.nfast}",
          flush=True)
    print(f"launches in {nsteps} steps: {counts}; plain-version calls: 0",
          flush=True)
    for name, n in counts.items():
        if n != nsteps:
            fail(f"{name}: {n} launches in {nsteps} steps, expected "
                 f"{nsteps}")
    for f in ("zeta", "ubar", "vbar", "u", "v", "t"):
        x = getattr(s, f)
        if not torch.isfinite(x).all():
            fail(f"full width: {f} not finite")
    zi = s.zeta[1:-1, 1:-1].double()
    vol = float(zi.mean())
    zmax = float(zi.abs().max())
    print(f"interior mean zeta {vol:.3e} (max|zeta| {zmax:.3e}), "
          f"max|u| {float(s.u.abs().max()):.3e}", flush=True)
    # float32 roundoff: the interior mean stays within eps32*max|zeta|
    if not abs(vol) <= 1.2e-7 * zmax:
        fail("interior volume not conserved to float32 roundoff")

    # per-kernel numbers at the main path's shapes
    env = setup(torch, Lm, Mm, N, "float32")
    table = []
    for name, (src, rep) in SOURCES.items():
        args, ins = entry_inputs(torch, name, *env, 5)
        rel, abs_err = compare(torch, name, args, "float32")
        if FAILURES:
            fail(FAILURES[-1])
        kern, plain = entry_fns(name)
        outs = as_tuple(kern(*args))
        byts = nbytes(ins) + nbytes(outs)
        npts = outs[0].numel()
        flops = FLOPS_PER_POINT[name] * npts
        t_bytes = 1e3 * byts / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / FP32_FLOPS
        ms = cuda_ms(torch, lambda: kern(*args), 20)
        plain_ms = cuda_ms(torch, lambda: plain(*args), 3)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": counts[name],
               "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None}
        print(f"{name:15s} {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{byts / 1e6:.1f} MB)  launches/step "
              f"{counts[name] / nsteps:g}  rel {rel:.2e}", flush=True)
        table.append(row)
    return table


def profile_step(torch):
    """Breakdown of one full-width float32 step: the fast barotropic
    loop vs the rest (CUDA events over 3 steps), then torch.profiler's
    device time by kernel over one step and the device's idle share."""
    from roms_tpu_torch.core.stepping import Model
    from roms_tpu_torch.functionals import idealized as ia
    cfg = ia.double_gyre_config(Lm=512, Mm=1024, N=30, dt=240.0,
                                ndtfast=30, dtype="float32")
    grid = ia.double_gyre_grid(cfg, device=DEVICE)
    s = ia.double_gyre_initial(cfg, grid)
    model = Model(cfg, grid, ia.double_gyre_forcing_fn(cfg, grid))
    s = model.step(s)
    inner = model.fast_loop
    fast_ms = []

    def timed_fast_loop(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args)
        b.record()
        fast_ms.append((a, b))
        return out

    model.fast_loop = timed_fast_loop
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    s = model.run(s, 3)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 3
    fl = sum(a.elapsed_time(b) for a, b in fast_ms) / 3
    print(f"step {step_ms:.3f} ms: fast loop {fl:.3f} ms "
          f"({model.nfast} substeps), rest {step_ms - fl:.3f} ms",
          flush=True)
    model.fast_loop = inner

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = model.step(s)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    # the profiler slows the host, so the idle share is taken against
    # the unprofiled step time above
    print(f"profiled step: wall {wall_ms:.3f} ms (profiler on), device "
          f"busy {busy_us / 1e3:.3f} ms, idle share vs the unprofiled "
          f"step {1 - busy_us / 1e3 / step_ms:.3f}, {launches} device "
          f"kernels", flush=True)
    ours = [e for e in rows if any(
        f"{k}_kernel<" in e.key for k in ("rho", "tadv", "rhs3d", "uv_solve",
                                          "uv_finish", "vdiff"))]
    ours_us = sum(e.self_device_time_total for e in ours)
    print(f"the port's CUDA kernels: {ours_us / 1e3:.3f} ms device time "
          f"in {sum(e.count for e in ours)} launches", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
