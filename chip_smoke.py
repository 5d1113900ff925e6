#!/usr/bin/env python3
"""GPU smoke test of roms_tpu_torch, the PyTorch/CUDA port of roms_tpu.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile  # only: where the full-width steps'
                                     # time goes (CUDA events, profiler),
                                     # the fast loop's by 2D term and
                                     # rhs3d's, uv_solve's, uv_finish's,
                                     # tadv's, prsgrd's, uvmix's, prep's,
                                     # spline_vdiff's, flux_omega's,
                                     # omega's, tridiag's, bulk_flux's and
                                     # kernel 12's time by launch shape

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card's name and power limit; build of the CUDA kernels from
     roms_tpu_torch/csrc (one nvcc per source, all started together),
     the registers and stack frame of the column sweeps (kernels 5, 6,
     14, 15 and 17), of the uvmix and flux_omega tiles (kernels 10, 7
     and 8), of the bulk-flux kernels (13) and of kernel 12;
  2. kernel phase: each kernel entry point against its plain PyTorch
     version on the card, same inputs, float64 (rel <= 1e-12; the fast
     loop, 2 x 42 substeps, 1e-11) and float32 (rel <= 1e-5), on seeded
     perturbations of the DOUBLE_GYRE state (the seven closed-basin entry
     points), of the UPWELLING state (all twelve, EW-periodic lanes) and
     of the BENCHMARK3 full-physics state (the fourteen entry points of
     its path, the channel kernels at N=30 with its spherical metrics,
     JM95 and 20-substep fast loop among them, plus KPP alone; the
     rotated tracer mixing also with closed walls; KPP's boundary-layer
     depths column by column), each at a moderate size whose Mj is not a
     multiple of the block size and at the full width; the batched
     tridiagonal solve of the GLS/MY2.5 path on seeded diagonally
     dominant systems and on the four real systems of a GLS and of a
     MY2.5 step at the same sizes, and kernels 1 (JM95) and 17 at the
     BENCHMARK3 shapes of the whole-array LMD route, kernel 17 also on
     the eight real systems of a step with LMD_BKPP and LMD_DDMIX; the
     j-blocked fast loop (kernel 12) on the UPWELLING and BENCHMARK3
     states (the latter's nfast = 29 odd),
     float64 rel <= 1e-11, with its difference from the resident fast
     loop (kernel 11) on the same inputs; the redesigned kernel 12 bitwise
     against kernel 11 and within the tolerance of the plain loop in both
     types at BLOCKED_SHAPES (the full-width shapes, a ragged grid with a
     one-row last tile, 4- and 5-lane channels of Mj = 4 and 5, 42
     substeps) from iic 0, 1 and 5; the redesigned tadv (kernel 2, both
     modes, 1, 2 and 5 tracers), rhs3d (kernel 3) and uv_solve (kernel
     4) on ragged grids and at minimal depths (N = 3 and 4), closed and
     EW-periodic, tadv's predictor and uv_solve from iic 0, 1 and 5,
     uv_finish (kernel 5) on the same grids, the redesigned prsgrd and
     uvmix (kernels 9 and 10) on ragged and 4-lane channels down to
     N = 2, the redesigned flux_omega (kernel 7) on the same channels, on
     4- and 5-lane channels of Mj = 4 down to N = 1 and on Mj = 43 (a
     last row tile of one row), omega (kernel 8) on the same grids, the
     bulk fluxes (kernel 13) on BENCHMARK3's plane and on planes of Mj =
     4, 5 and 43 (an odd Li) in both stability regimes, with cool skin,
     COARE 3.5 and blk_zq other than blk_zt, one launch a call, the
     redesigned tridiagonal solve (kernel 17) on seeded systems of 1, 2,
     15, 30 and 128 levels (kernels 7, 8, 13 and 17 bitwise or fail),
     the column sweeps of prep, KPP alone and spline_vdiff (kernels 15,
     14 and 6) on the same grids and at N = 2 on a 4-lane
     channel, KPP's boundary layer column by column with a statically
     unstable column every other one, spline_vdiff at one, two and five
     tracers with one or two Akt profiles and bitwise, each redesign line
     saying whether it is bitwise, and the float64 launches over a
     block's shared memory refused (the tiled kernels with a (64, 128)
     tile, kernel 12 with the float32 tile, the column sweeps and
     flux_omega's and omega's running sums at the shallowest depth over
     it);
  3. slice parity, kernels vs `Model(use_kernels=False)`, float64, 5
     steps, within 1e-10*max|x| + 5e-14: DOUBLE_GYRE Lm=64, Mm=128, N=10,
     UPWELLING Lm=48, Mm=64, N=16 with the analytic, the GLS
     (Kantha-Clayson) and the MY2.5 closure (the turbulence fields too)
     and BENCHMARK full physics Lm=64, Mm=32, N=16, all but the first
     from a zonally varying state; UPWELLING (analytic and GLS) and
     BENCHMARK again with `Model(fast_loop="blocked")`; BENCHMARK with
     LMD_BKPP and LMD_DDMIX (`benchmark_lmd_bl`, the whole-array LMD
     route); BASIN, SEAMOUNT, GRAV_ADJ, WINDBASIN, CANYON, CHANNEL,
     LAKE_SIGNELL, LMD_TEST, MIXED_LAYER and LAB_CANYON at their
     published sizes, from their initial states with the same seeded
     noise; every kernel launched exactly its path's count and no other,
     and a line saying whether the kernel path is bitwise equal;
  4. full width, float32, 10 steps after a warm-up step, ms/step from
     CUDA events, each entry point's launches in the run and no plain
     version called: DOUBLE_GYRE Lm=512, Mm=1024, N=30 (dt=240 s; finite
     fields, interior volume conserved), UPWELLING Lm=512, Mm=1024, N=16
     (the published dx = 1 km, dt = 300 s, ndtfast = 30; finite fields,
     interior volume, zeta x-uniform), the same channel with GLS and
     with MY2.5 (tridiag launched 4 times a step; tke, gls and Akv at
     or above the closure's floors) and BENCHMARK3 full physics
     Lm=2048, Mm=256, N=30 (dt = 150 s, ndtfast = 20 as published;
     finite fields, interior volume, the KPP boundary layer inside the
     water column); `benchmark_lmd_bl`, BENCHMARK3 full physics with
     LMD_BKPP and LMD_DDMIX at the same size (kernel 1 once and kernel 17
     eight times a step at (29, 258, 2050), no prep; both boundary
     layers inside the water column), its ms/step beside BENCHMARK3's;
     BENCHMARK3 and UPWELLING again with the j-blocked
     fast loop (15 and 21 launches of kernel 12 a step, none of kernel
     11), the fast loop's own time inside the step under each engine,
     and kernel 12's design floor and device scratch; then each kernel's
     time at its path's full-width
     shapes next to its plain version, its bound (for the bulk fluxes
     the larger of its bytes and its issue floor, the warp instructions
     on the shortest path through its SASS over the card's issue rate)
     and, for the tridiagonal solve, torch.linalg.solve on the same
     systems (kernels 1 and 17 at the LMD path's shapes); after
     the checks, three more 10-step windows of each app, timed by CUDA
     events and on the host, and the card's SM clock during a fourth,
     for the step's spread within one call;
  5. the deck driver, `python -m roms_tpu_torch`: (a) in process, an
     UPWELLING deck in the reference format at 512 x 1024 x 16, float32,
     20 steps, HIS and AVG every 10 steps, RST at 20, STA every step at 4
     stations, NINFO every 5: the files and their record counts, finite
     fields, every channel entry point launched and no plain version
     called, the driver's ms/step beside phase 4's bare step and each
     output event's seconds; (b) restart bit for bit: the RST record
     against the final state, and 3 + 3 float64 steps through
     read_restart against 6 at 48 x 64 x 16; (c) as subprocesses, all
     started together, the BENCHMARK deck at 64 x 32 x 16 and each of
     the ten apps' decks at its published size, 3 steps each, exit 0;
  last, torch.profiler's device kernels of one bulk_flux call (only
  csrc/bulk.cu's: its wrapper launches no PyTorch operation).
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12            # H100 SXM float32, non-tensor
TOL = {"float64": 1e-12, "float32": 1e-5}
# the fast loops' float64 bound: 2 x 42 substeps, the reference's own
# bound for its engine (tests/test_pallas_step2d.py:56)
TOL_F64 = {"fast_loop_res": 1e-11, "fast_loop_blocked": 1e-11}
DEVICE = "cuda"
FAILURES = []       # kernel-vs-plain excesses, reported at phase end
CARD = ""           # nvidia-smi's name and power limit
BARE_MS = {}        # phase 4's bare Model.run ms/step of each full app


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
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    CARD = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi unavailable: {smi.stderr.strip()}"
    print(CARD, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _lib.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_lib.build_seconds:.1f} s)", flush=True)
    print(_lib.ptxas_report(), flush=True)
    ptxas_summary(("kpp_kernel", "vdiff_kernel", "uv_finish_kernel",
                   "uvmix_kernel", "flux_omega_kernel", "tridiag_kernel",
                   "bulk_kernel", "stagger_kernel", "blocked_kernel"))
    _lib.lib()

    full = [app for app in APPS if APPS[app]["full"]]
    if "--profile" in sys.argv[1:]:
        for app in full:
            profile_step(torch, app)
        for app in ("benchmark", "upwelling"):
            fast_loop_terms(torch, app)
            launch_shapes(torch, app)
        return 0
    kernel_phase_checks(torch)
    for app in APPS:
        slice_parity(torch, app)
    counts = {app: full_width(torch, app) for app in full}
    print(f"full width benchmark_lmd_bl {BARE_MS['benchmark_lmd_bl']:.3f} "
          f"ms/step beside the default BENCHMARK3's "
          f"{BARE_MS['benchmark']:.3f} ms/step in this call (CUDA events, "
          f"10 steps each) [{CARD}]", flush=True)
    # one row per entry point, at the newest path that times it (the GLS
    # path times only the solve it adds to the channel's kernels, the
    # blocked paths only kernel 12, whose row is BENCHMARK3's, the LMD
    # path kernels 1 and 17 at BENCHMARK3's shapes)
    table = []
    for app in ("benchmark_lmd_bl", "benchmark_blocked",
                "upwelling_blocked", "upwelling_gls", "benchmark",
                "upwelling", "double_gyre"):
        rows = kernel_table(torch, app, counts[app])
        done = {row["name"] for row in table}
        table += [row for row in rows if row["name"] not in done]
    deck_phase(torch)
    # last, since a process that has run torch.profiler issues every later
    # launch more slowly (DOUBLE_GYRE's host-bound step, 35238 launches,
    # read ~90 ms/step slower after it)
    bulk_alone(torch)
    if FAILURES:
        fail(FAILURES[-1])
    files = sorted({os.path.basename(src) for src, _ in SOURCES.values()})
    print(f"kernels: {files} ({len(files)} files, {len(table)} entry "
          f"points)", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ptxas_summary(kernels):
    """One line per compiled kernel whose name starts with one of
    `kernels`: its registers and stack frame from `ptxas -v` (the first
    of each under the kernel's name; the lines of a function it calls
    follow them)."""
    import re
    from roms_tpu_torch.ops import _lib
    name, seen = None, {}
    for line in _lib.ptxas_report().splitlines():
        text = line.partition(": ")[2]
        if not text.startswith(" "):
            m = re.search(r"(%s)<[^>]*>" % "|".join(kernels), text)
            name = m.group(0) if m else None
        elif name:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("stack", r"(\d+) bytes stack frame")):
                m = re.search(pat, text)
                if m:
                    seen.setdefault(name, {}).setdefault(key,
                                                         int(m.group(1)))
    for name, r in seen.items():
        print(f"ptxas {name}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack frame", flush=True)


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
    "flux_omega": ("roms_tpu_torch/csrc/flux.cu",
                   "roms_tpu/ops/pallas_flux.py:152"),
    "omega": ("roms_tpu_torch/csrc/flux.cu",
              "roms_tpu/ops/pallas_flux.py:185"),
    "prsgrd32": ("roms_tpu_torch/csrc/prsgrd.cu",
                 "roms_tpu/ops/pallas_prsgrd.py:191"),
    "uv3dmix2_s": ("roms_tpu_torch/csrc/uvmix.cu",
                   "roms_tpu/ops/pallas_uvmix.py:143"),
    "fast_loop_res": ("roms_tpu_torch/csrc/step2d.cu",
                      "roms_tpu/ops/pallas_step2d.py:804"),
    "bulk_flux": ("roms_tpu_torch/csrc/bulk.cu",
                  "roms_tpu/ops/pallas_bulk.py:41"),
    "kpp": ("roms_tpu_torch/csrc/kpp.cu", "roms_tpu/ops/pallas_kpp.py:289"),
    "prep": ("roms_tpu_torch/csrc/kpp.cu", "roms_tpu/ops/pallas_prep.py:76"),
    "rot_div_geo": ("roms_tpu_torch/csrc/hmix.cu",
                    "roms_tpu/ops/pallas_hmix.py:185"),
    "tridiag": ("roms_tpu_torch/csrc/tridiag.cu",
                "roms_tpu/ops/pallas_tridiag.py:60"),
    "fast_loop_blocked": ("roms_tpu_torch/csrc/step2d_blocked.cu",
                          "roms_tpu/ops/pallas_step2d.py:600"),
}
SLICE1 = list(SOURCES)[:7]
SLICE2 = list(SOURCES)[:12]

# flops per output point (per level for column kernels, per substep for
# the fast loop), counted by hand from the plain versions' arithmetic,
# each intermediate once; only used for the operations bound
FLOPS_PER_POINT = {"rho_eos": 12, "tadv_predictor": 90,
                   "tadv_corrector": 80, "rhs3d_momentum": 220,
                   "uv_solve": 60, "uv_finish": 30, "spline_vdiff": 25,
                   "flux_omega": 15, "omega": 7, "prsgrd32": 130,
                   "uv3dmix2_s": 60, "fast_loop_res": 470,
                   "bulk_flux": 700, "kpp": 160, "prep": 230,
                   "rot_div_geo": 85, "tridiag": 9,
                   "fast_loop_blocked": 470}
# (Mj, Li) planes a kernel-11 launch after the first substep reads or
# writes, each once (csrc/step2d.cu).  Predictor: the state zeta, ubar,
# vbar 3, the statics 3 (flux) + 3 (zeta) + 18 (momentum), the
# averages 5 in and out, zeta_prev, ubar_prev, vbar_prev, rufrc, rvfrc,
# and rhs_zeta, zeta_p, ru_m, rv_m, ubar_p, vbar_p out: 48.  Corrector:
# the state 3, the statics 24, DU2/DV2 in and out, zeta, rz_m, rz_prev,
# ubar, vbar, rufrc, rvfrc, ru_m, rv_m, ru_prev, rv_prev, and zeta_c,
# ubar and vbar out: 45.  For the design floor line.
FAST_LOOP_PLANES_PER_LAUNCH = {"predictor": 48, "corrector": 45}

APPS = {
    "double_gyre": dict(entries=SLICE1, dt=240.0,
                        kernel_sizes=((128, 256, 30), (512, 1024, 30)),
                        parity=(64, 128, 10, 1800.0),
                        full=(512, 1024, 30)),
    "upwelling": dict(entries=SLICE2, dt=300.0,
                      kernel_sizes=((100, 203, 16), (512, 1024, 16)),
                      parity=(48, 64, 16, 300.0),
                      full=(512, 1024, 16)),
    # the path runs the channel kernels with kernel 15 in place of rho
    # and kernels 13 and 16; KPP alone (kernel 14, the same column
    # without the EOS) is off it, and is checked and timed at its shapes
    "benchmark": dict(entries=[n for n in SOURCES if n not in (
                          "rho_eos", "kpp", "tridiag", "fast_loop_blocked")],
                      off_path=["kpp"], dt=150.0,
                      kernel_sizes=((201, 101, 30), (2048, 256, 30)),
                      parity=(64, 32, 16, 150.0),
                      full=(2048, 256, 30)),
    # the channel with the GLS (Kantha-Clayson, upwelling.h:44-47) and
    # MY2.5 closures: the twelve channel entry points, checked under
    # "upwelling" at the same shapes, plus the tridiagonal solve four
    # times a step
    "upwelling_gls": dict(entries=SLICE2 + ["tridiag"], checked=["tridiag"],
                          per_step={"tridiag": 4}, dt=300.0,
                          kernel_sizes=((100, 203, 16), (512, 1024, 16)),
                          parity=(48, 64, 16, 300.0), full=(512, 1024, 16),
                          mixing=dict(vmix="gls",
                                      gls_stab="kantha_clayson")),
    "upwelling_my25": dict(entries=SLICE2 + ["tridiag"], checked=[],
                           per_step={"tridiag": 4}, dt=300.0,
                           kernel_sizes=((100, 203, 16), (512, 1024, 16)),
                           parity=(48, 64, 16, 300.0),
                           full=(512, 1024, 16), mixing=dict(vmix="my25")),
}
# the channel paths with the j-blocked fast loop (kernel 12) in place of
# the resident one: one launch per chunk of chunk_schedule(nfast), 21 a
# step at UPWELLING's nfast = 42 and 15 at BENCHMARK3's nfast = 29; the
# other entry points are checked under their default apps
for _app, _launches, _alone in (("upwelling", 21, True),
                                ("upwelling_gls", 21, False),
                                ("benchmark", 15, True)):
    # the GLS channel only for its parity: its fast loop inputs and full
    # width are the analytic channel's
    _spec = APPS[_app]
    APPS[_app + "_blocked"] = dict(
        _spec, base=_app, fast_loop="blocked", checked=["fast_loop_blocked"],
        off_path=[], full=_spec["full"] if _alone else None,
        kernel_sizes=_spec["kernel_sizes"] if _alone else (),
        entries=[n for n in _spec["entries"] if n != "fast_loop_res"]
        + ["fast_loop_blocked"],
        per_step=dict(_spec.get("per_step", {}),
                      fast_loop_blocked=_launches))
BLOCKED = [a for a in APPS if a.endswith("_blocked")]
# BENCHMARK3 with LMD's bottom boundary layer and double diffusion
# (BL_TEST's closure set, roms_tpu/functionals/idealized.py:874): the
# whole-array LMD route, kernel 1's EOS in place of prep's and kernel 17
# eight times a step at (N-1, Mj, Li) (two solves of the interior shear,
# three of the surface layer, three of the bottom one); the other entry
# points are checked under "benchmark" at the same shapes, kernel 1 here
# at BENCHMARK3's (JM95) and kernel 17 on seeded systems and on the eight
# real systems of a step
APPS["benchmark_lmd_bl"] = dict(
    APPS["benchmark"], base="benchmark", off_path=[],
    entries=[n for n in SOURCES
             if n not in ("kpp", "prep", "fast_loop_blocked")],
    checked=["rho_eos", "tridiag"], per_step={"tridiag": 8},
    mixing=dict(bkpp=True, ddmix=True))
# the analytical apps that need only ported physics: phase 3's parity at
# their published sizes (the config defaults, parity None), the closed
# basins on the DOUBLE_GYRE kernels, the channels on UPWELLING's and
# CANYON with the rotated tracer mixing; LAKE_SIGNELL's closed lake with
# GLS (four solves a step), the NS-periodic LMD_TEST (LMD_BKPP, eight),
# MIXED_LAYER (GLS, four) and LAB_CANYON outside every tiled kernel's
# class (tests/test_torch_kernels.py APP_KERNELS)
IDEALIZED = {"basin": SLICE1, "seamount": SLICE1, "grav_adj": SLICE1,
             "windbasin": SLICE1, "canyon": SLICE2 + ["rot_div_geo"],
             "channel": SLICE2, "lake_signell": SLICE1 + ["tridiag"],
             "lmd_test": ["rho_eos", "spline_vdiff", "tridiag"],
             "mixed_layer": ["rho_eos", "spline_vdiff", "tridiag"],
             "lab_canyon": ["rho_eos", "spline_vdiff"]}
IDEALIZED_SOLVES = {"lake_signell": 4, "lmd_test": 8, "mixed_layer": 4}
for _app, _entries in IDEALIZED.items():
    APPS[_app] = dict(
        entries=_entries, dt=None, kernel_sizes=(),
        parity=(None, None, None, None), full=None,
        per_step={"tridiag": IDEALIZED_SOLVES[_app]}
        if _app in IDEALIZED_SOLVES else {})
# the laboratory tank (2.5-12.5 cm deep, azimuthal cells down to 3.5 mm)
# moves at mm/s: 5 cm/s of noise blows it up within three steps in
# either path, 5 mm/s does not
APPS["lab_canyon"]["noise"] = 0.005


def app_setup(app, Lm, Mm, N, dtype, dt):
    """(cfg, grid, initial state, model kwargs) of an application."""
    closure = APPS[app].get("mixing")
    app = APPS[app].get("base", app)
    if app in IDEALIZED:
        from roms_tpu_torch.functionals import idealized as ia
        kw = dict(dtype=dtype) if Lm is None else dict(
            Lm=Lm, Mm=Mm, N=N, dt=dt, dtype=dtype)
        cfg = getattr(ia, f"{app}_config")(**kw)
        grid = getattr(ia, f"{app}_grid")(cfg, device=DEVICE)
        forcing = getattr(ia, f"{app}_forcing_fn", None)
        forcing = forcing(cfg, grid) if forcing else \
            ia.zero_forcing(cfg, grid)
        return cfg, grid, getattr(ia, f"{app}_initial")(cfg, grid), dict(
            forcing_fn=forcing)
    if app == "double_gyre":
        from roms_tpu_torch.functionals import idealized as ia
        cfg = ia.double_gyre_config(Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=30,
                                    dtype=dtype)
        grid = ia.double_gyre_grid(cfg, device=DEVICE)
        return cfg, grid, ia.double_gyre_initial(cfg, grid), dict(
            forcing_fn=ia.double_gyre_forcing_fn(cfg, grid))
    if app == "benchmark":
        from roms_tpu_torch.functionals import benchmark as bm
        cfg = bm.make_config(Lm=Lm, Mm=Mm, N=N, dt=dt, dtype=dtype,
                             full_physics=True)
        if closure:
            cfg = cfg.replace(mixing=dataclasses.replace(cfg.mixing,
                                                         **closure))
        grid = bm.make_grid(cfg, device=DEVICE)
        return cfg, grid, bm.make_initial(cfg, grid), dict(
            forcing_fn=bm.make_bulk_forcing_fn(cfg, grid))
    from roms_tpu_torch.functionals import upwelling as up
    cfg = up.make_config(Lm=Lm, Mm=Mm, N=N, dt=dt, dtype=dtype)
    if closure:
        cfg = cfg.replace(mixing=dataclasses.replace(cfg.mixing, **closure))
    grid = up.make_grid(cfg, device=DEVICE)
    kw = dict(forcing_fn=up.make_forcing_fn(cfg, grid))
    if not closure:
        kw["vmix_fn"] = up.make_vmix_fn(cfg)
    return cfg, grid, up.make_initial(cfg, grid), kw


def setup(torch, Lm, Mm, N, dtype, seed=7, app="double_gyre"):
    """config/grid/state of an application at the given size with seeded
    (zonally varying) perturbations, made on the card."""
    from roms_tpu_torch.grid.depth import set_depth
    cfg, grid, s, _ = app_setup(app, Lm, Mm, N, dtype, APPS[app]["dt"])
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
    from roms_tpu_torch.ops import stencil as st
    N = cfg.N
    shp2, shp3 = cfg.shape2d, (N,) + cfg.shape2d
    t = s.t + 0.1 * rnd(*s.t.shape)
    u = 0.1 * rnd(*shp3) * grid.umask
    v = 0.1 * rnd(*shp3) * grid.vmask
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    if cfg.bc.ew_periodic:
        Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    W = omega(cfg, grid, Huon, Hvom, z_w)
    if name == "tridiag":
        # diagonally dominant systems on the N-1 interior interfaces,
        # the shape of the GLS/MY2.5 solves
        shp = (N - 1,) + shp2
        lower, upper = 0.5 * rnd(*shp), 0.5 * rnd(*shp)
        diag = 2.0 + lower.abs() + upper.abs() + rnd(*shp).abs()
        rhs = rnd(*shp)
        return (lower, diag, upper, rhs), [lower, diag, upper, rhs]
    if name == "rho_eos":
        args = (cfg, t, z_r, Hz, z_w)
        return args, [t, z_r, Hz, z_w]
    if name == "tadv_predictor":
        t_prev = t + 0.01 * rnd(*t.shape)
        args = (cfg, grid, t, t_prev, Huon, Hvom, W, Hz,
                *tracer_predictor_coefs(cfg, iic))
        return args, [t, t_prev, Huon, Hvom, W, Hz, grid.pm, grid.pn,
                      grid.umask, grid.vmask]
    if name == "tadv_corrector":
        t_part = Hz * t
        args = (cfg, grid, t, t_part, Huon, Hvom, W, Hz)
        return args, [t, t_part, Huon, Hvom, W, grid.pm, grid.pn,
                      grid.umask, grid.vmask]
    if name == "rhs3d_momentum":
        ru, rv = rnd(*shp3), rnd(*shp3)
        args = (cfg, grid, u, v, Hz, Huon, Hvom, W, ru, rv)
        return args, [u, v, Hz, Huon, Hvom, W, ru, rv, grid.fomn]
    Akv = 1e-3 * torch.abs(rnd(N + 1, *shp2)) + 1e-5
    D = torch.sum(Hz, dim=0)
    if name == "uv_solve":
        u_part, v_part = u * Hz, v * Hz
        ru, rv = 1e-2 * rnd(*shp3), 1e-2 * rnd(*shp3)
        DU1 = 0.01 * rnd(*shp2) * D * grid.on_u
        DV1 = 0.01 * rnd(*shp2) * D * grid.om_v
        args = (cfg, grid, u_part, v_part, ru, rv, Hz, Akv,
                ab3_lead(cfg, iic), DU1, DV1)
        return args, [u_part, v_part, ru, rv, Hz, Akv, grid.pm, grid.pn,
                      grid.umask, grid.vmask, grid.on_u, grid.om_v, DU1,
                      DV1]
    if name == "uv_finish":
        DU = [0.01 * rnd(*shp2) * D * m
              for m in (grid.on_u, grid.om_v, grid.on_u, grid.om_v)]
        args = (cfg, grid, u, v, Hz, Huon, Hvom, *DU)
        return args, [u, v, Hz, Huon, Hvom, grid.umask, grid.vmask,
                      grid.on_u, grid.om_v, *DU]
    if name == "spline_vdiff":
        Akt = 1e-3 * torch.abs(rnd(cfg.NAT, N + 1, *shp2)) + 1e-6
        pre = Hz * t
        return (cfg, pre, Hz, Akt), [pre, Hz, Akt]
    if name == "flux_omega":
        args = (cfg, grid, u, v, Hz, z_w)
        return args, [u, v, Hz, z_w, grid.on_u, grid.om_v]
    if name == "omega":
        return (cfg, grid, Huon, Hvom, z_w), [Huon, Hvom, z_w]
    if name == "bulk_flux":
        return bulk_inputs(torch, cfg, grid, t, z_r, rnd)
    if name == "rot_div_geo":
        args = (cfg, grid, t, grid.diff2, Hz, z_r)
        return args, [t, z_r, Hz, grid.pm, grid.pn, grid.umask, grid.vmask,
                      grid.on_u, grid.om_v, grid.diff2]
    from roms_tpu_torch.ops import rho as rho_op
    rho, pden, rhoA, rhoS, bvf = rho_op.rho_eos_plain(cfg, t, z_r, Hz, z_w)
    if name in ("kpp", "prep"):
        # seeded surface forcing: buoyancy fluxes of both signs (Bfsfc
        # both ways, the Ekman/Monin-Obukhov cap where it is positive),
        # friction velocities with some zeros; in KPP mode a third of the
        # columns statically unstable, where no critical Richardson
        # number is crossed
        u_r = 0.5 * (u + st.ip1(u))
        v_r = 0.5 * (v + st.jp1(v))
        Ustar = 0.01 * torch.abs(rnd(*shp2))
        Ustar = torch.where(rnd(*shp2) > 1.28, 0.0, Ustar)
        planes = [Ustar, 3e-8 * rnd(*shp2), 1e-8 * torch.abs(rnd(*shp2)),
                  torch.abs(grid.f), 1e-5 * rnd(*shp2), 1e-6 * rnd(*shp2),
                  2e-5 * torch.abs(rnd(*shp2))]
        if name == "kpp":
            flip = torch.where(rnd(*shp2) < -0.52, -1.0, 1.0)
            cols = [u_r, v_r, pden * flip, bvf * flip, Hz, z_w]
            return (cfg, *cols, *planes), cols + planes
        cols = [t, z_r, Hz, z_w, u_r, v_r]
        return (cfg, *cols, *planes), cols + planes
    if name == "prsgrd32":
        args = (cfg, grid, rho, z_r, z_w, Hz)
        return args, [rho, z_r, Hz, z_w[N], grid.umask, grid.vmask,
                      grid.on_u, grid.om_v]
    if name == "uv3dmix2_s":
        from roms_tpu_torch.ops.uvmix import METRICS
        rufrc = 1e-5 * rnd(*shp2) * grid.om_u * grid.on_u
        rvfrc = 1e-5 * rnd(*shp2) * grid.om_v * grid.on_v
        args = (cfg, grid, u, v, u * Hz, v * Hz, Hz, rufrc, rvfrc)
        return args, [u, v, Hz, u * Hz, v * Hz, rufrc, rvfrc] + [
            getattr(grid, n) for n in METRICS]
    if name in ("fast_loop_res", "fast_loop_blocked"):
        from roms_tpu_torch.core.weights import power_law_weights
        from roms_tpu_torch.ops.step2d import STATICS
        nfast, w1, w2 = power_law_weights(cfg.ndtfast)
        ubar = 0.05 * rnd(*shp2) * grid.umask
        vbar = 0.05 * rnd(*shp2) * grid.vmask
        f2 = [1e-5 * rnd(*shp2) * grid.om_u * grid.on_u for _ in range(6)]
        dyn = [z_w[N], ubar, vbar, f2[0], f2[1], rhoS, rhoA, *f2[2:]]
        args = (cfg, grid, nfast, w1, w2, True, *dyn, iic)
        return args, dyn + [getattr(grid, n) for n in STATICS]
    raise KeyError(name)


def bulk_inputs(torch, cfg, grid, t, z_r, rnd):
    """Seeded atmosphere over the analytic one's shortwave at the model's
    start (January 1, part of the channel in daylight): winds of both
    signs, nonzero Vwind and rain, air temperatures on both sides of the
    SST, relative and specific humidities."""
    from roms_tpu_torch.core.bulk_flux import AtmState
    from roms_tpu_torch.functionals import benchmark as bm
    from roms_tpu_torch.ops.prep import surface_rho
    shp2 = cfg.shape2d
    sst, sss = t[0][-1], t[1][-1]
    Hair = torch.clamp(0.8 + 0.1 * rnd(*shp2), 0.3, 1.0)
    atm = AtmState(
        Uwind=10.0 * rnd(*shp2), Vwind=5.0 * rnd(*shp2),
        Tair=sst + 2.0 * rnd(*shp2), Pair=1013.0 + 10.0 * rnd(*shp2),
        Hair=torch.where(rnd(*shp2) > 0.67, 12.0, Hair),
        cloud=torch.clamp(0.5 + 0.2 * rnd(*shp2), 0.0, 1.0),
        rain=1e-4 * torch.abs(rnd(*shp2)),
        srflx=bm.make_atm_fn(cfg, grid)(0.0).srflx)
    rho_surf = surface_rho(cfg, t, z_r)
    return (cfg, atm, sst, sss, rho_surf), list(atm) + [sst, sss, rho_surf]


def entry_fns(name):
    from roms_tpu_torch.ops import (bulk, flux, hmix, kpp, prep, prsgrd, rho,
                                    rhs3d, step2d, tadv, tridiag, uv, uvmix,
                                    vdiff)
    return {
        "rho_eos": (rho.rho_eos, rho.rho_eos_plain),
        "tadv_predictor": (tadv.predictor, tadv.predictor_plain),
        "tadv_corrector": (tadv.corrector, tadv.corrector_plain),
        "rhs3d_momentum": (rhs3d.rhs3d_momentum,
                           rhs3d.rhs3d_momentum_plain),
        "uv_solve": (uv.uv_solve, uv.uv_solve_plain),
        "uv_finish": (uv.uv_finish, uv.uv_finish_plain),
        "spline_vdiff": (vdiff.spline_vdiff, vdiff.spline_vdiff_plain),
        "flux_omega": (flux.flux_omega, flux.flux_omega_plain),
        "omega": (flux.omega, flux.omega_plain),
        "prsgrd32": (prsgrd.prsgrd32, prsgrd.prsgrd32_plain),
        "uv3dmix2_s": (uvmix.uv3dmix2_s, uvmix.uv3dmix2_s_plain),
        "fast_loop_res": (step2d.fast_loop_res,
                          step2d.fast_loop_res_plain),
        "fast_loop_blocked": (step2d.fast_loop_blocked,
                              step2d.fast_loop_res_plain),
        "bulk_flux": (bulk.bulk_flux, bulk.bulk_flux_plain),
        "kpp": (kpp.kpp, kpp.kpp_plain),
        "prep": (prep.prep, prep.prep_plain),
        "rot_div_geo": (hmix.rot_div_geo, hmix.rot_div_geo_plain),
        "tridiag": (tridiag.tridiag_solve, tridiag.tridiag_plain),
    }[name]


def outputs(x):
    """The output tensors of an entry point: a FastCarry gives its 16
    carry fields (ru0/rv0 are its inputs)."""
    if hasattr(x, "avg"):
        return tuple(x)[:11] + tuple(x.avg)
    return x if isinstance(x, tuple) else (x,)


def compare(torch, name, args, dtype):
    """Kernel vs plain on the same inputs; returns (max rel, max abs)."""
    kern, plain = entry_fns(name)
    got = outputs(kern(*args))
    ref = outputs(plain(*args))
    torch.cuda.synchronize()
    rel = abs_err = 0.0
    for g, r in zip(got, ref):
        if not torch.isfinite(g).all():
            fail(f"{name} {dtype}: non-finite kernel output")
        d = float((g - r).abs().max())
        scale = float(r.abs().max()) + 1e-300
        rel = max(rel, d / scale)
        abs_err = max(abs_err, d)
    tol = TOL_F64.get(name, TOL[dtype]) if dtype == "float64" \
        else TOL[dtype]
    if rel > tol:
        FAILURES.append(f"{name} {dtype}: rel err {rel:.3e} > {tol:.0e}")
    return rel, abs_err


def hsbl_check(torch, name, args, dtype, label="kernel benchmark  ",
               regimes=None):
    """KPP's boundary-layer depth column by column, kernel against plain:
    one rounding apart at a threshold test moves a whole column.  Prints
    the columns that differ and the seeded regimes the inputs reach;
    with `regimes` (KPP alone by default) each must be reached."""
    kern, plain = entry_fns(name)
    h_k, h_p = kern(*args)[-1], plain(*args)[-1]
    z_w = args[6] if name == "kpp" else args[4]
    Ustar, Bo = args[7], args[8]
    torch.cuda.synchronize()
    tol = TOL[dtype] * float(h_p.abs().max())
    moved = int(((h_k - h_p).abs() > tol).sum())
    no_cross = int((h_p == z_w[1]).sum())
    stable = int(((Bo > 0) & (Ustar > 0)).sum())
    print(f"{label} {name:15s} {dtype}: hsbl columns off by more "
          f"than {TOL[dtype]:.0e} rel: {moved} of {h_p.numel()}; plain "
          f"columns with no crossing (hsbl = z_w[1]) {no_cross}, under "
          f"stable forcing (Bo > 0, Ustar > 0) {stable}, unstable (Bo < 0) "
          f"{int((Bo < 0).sum())}", flush=True)
    if moved:
        FAILURES.append(f"{name} {dtype}: {moved} hsbl columns moved")
    if regimes is None:
        regimes = name == "kpp"
    if regimes and not (0 < no_cross < h_p.numel() and stable
                        and (Bo < 0).any()):
        FAILURES.append(f"{name} {dtype}: the seeded columns miss a regime")


def kernel_phase_checks(torch):
    from roms_tpu_torch.config import LBC, BoundaryConfig
    from roms_tpu_torch.ops import _lib
    for app, spec in APPS.items():
        for (Lm, Mm, N) in spec["kernel_sizes"]:
            for dtype in ("float64", "float32"):
                env = setup(torch, Lm, Mm, N, dtype, app=app)
                for name in spec.get("checked", spec["entries"]) + \
                        spec.get("off_path", []):
                    iics = (0, 1, 5) if name in (
                        "tadv_predictor", "uv_solve") else (
                        (0, 5) if name.startswith("fast_loop") else (5,))
                    for iic in iics:
                        args, _ = entry_inputs(torch, name, *env, iic)
                        rel, abs_err = compare(torch, name, args, dtype)
                        print(f"kernel {app:11s} {name:15s} {dtype} N={N} "
                              f"Mj={Mm + 2} Li={Lm + 2} iic={iic}: max rel "
                              f"{rel:.3e} max abs {abs_err:.3e}", flush=True)
                        if name == "fast_loop_blocked":
                            print(f"  kernel 12 vs kernel 11 on the same "
                                  f"inputs (nfast={args[2]}): max rel "
                                  f"{engine_diff(torch, args):.3e}",
                                  flush=True)
                if app == "double_gyre":
                    # the rho kernel's JM95 branch (off both paths)
                    args, _ = entry_inputs(torch, "rho_eos", *env, 5)
                    cfg = args[0]
                    args = (cfg.replace(eos=cfg.eos.__class__(linear=False)),
                            *args[1:])
                    rel, abs_err = compare(torch, "rho_eos", args, dtype)
                    print(f"kernel rho_eos JM95     {dtype} N={N} "
                          f"Mj={Mm + 2} Li={Lm + 2}: max rel {rel:.3e} max "
                          f"abs {abs_err:.3e}", flush=True)
                if app == "benchmark":
                    for name in ("kpp", "prep"):
                        args, _ = entry_inputs(torch, name, *env, 5)
                        hsbl_check(torch, name, args, dtype)
                    # the rotated mixing with closed walls all round
                    args, _ = entry_inputs(torch, "rot_div_geo", *env, 5)
                    cfg = args[0].replace(bc=BoundaryConfig.uniform(LBC()))
                    rel, abs_err = compare(torch, "rot_div_geo",
                                           (cfg, *args[1:]), dtype)
                    print(f"kernel rot_div_geo closed {dtype} N={N} "
                          f"Mj={Mm + 2} Li={Lm + 2}: max rel {rel:.3e} max "
                          f"abs {abs_err:.3e}", flush=True)
                if spec.get("mixing"):
                    systems = closure_systems(torch, app, Lm, Mm, N, dtype)
                    want = spec["per_step"]["tridiag"]
                    if len(systems) != want:
                        FAILURES.append(f"{app}: {len(systems)} tridiag "
                                        f"solves in a step, expected {want}")
                    for i, args in enumerate(systems):
                        rel, abs_err = compare(torch, "tridiag", args,
                                               dtype)
                        print(f"kernel {app:11s} tridiag {dtype} step "
                              f"system {i} {tuple(args[3].shape)}: max rel "
                              f"{rel:.3e} max abs {abs_err:.3e}", flush=True)
                del env
                torch.cuda.empty_cache()
    redesign_checks(torch)
    if FAILURES:
        fail("kernel phase:\n  " + "\n  ".join(FAILURES))
    _lib.reset_launches()


# (app, (Lm, Mm, N)) of the redesigned kernels 2, 3 and 4: grids that no
# tile divides (Mj = 21, Li = 39 and 47; DOUBLE_GYRE's Mj = 63), the
# smallest channel (Mj = Li = 4) and the minimal depths
REDESIGN_SHAPES = [("upwelling", (37, 19, 3)), ("benchmark", (45, 19, 4)),
                   ("upwelling", (2, 2, 3)), ("double_gyre", (30, 61, 4))]
# kernels 9 and 10's shapes: the channels of REDESIGN_SHAPES (their class
# is EW-periodic) and N = 2 on a 4-lane and a ragged grid
PRSGRD_SHAPES = [s for s in REDESIGN_SHAPES if s[0] != "double_gyre"] + [
    ("upwelling", (2, 3, 2)), ("benchmark", (45, 19, 2))]
# kernel 7's shapes: PRSGRD_SHAPES, a 4-lane channel of Mj = 4, a 5-lane
# channel of Mj = 4 and N = 1, and Mj = 43, whose last row tile of
# ops/flux.py TILE has one row
FLUX_SHAPES = PRSGRD_SHAPES + [("upwelling", (2, 2, 2)),
                               ("upwelling", (3, 2, 1)),
                               ("upwelling", (37, 41, 3))]
# kernel 13's (Lm, Mm) planes on the BENCHMARK grid: BENCHMARK3's
# (258 x 2050), Mj = Li = 4 and 5, and Mj = 43 with an odd Li = 47; each
# with the flags (cool_skin, coare35) of BULK_FLAGS and blk_zq of BULK_ZQ
# (10 m is blk_zt, 2 m not)
BULK_PLANES = [(2048, 256), (2, 2), (3, 3), (45, 41)]
BULK_FLAGS = [(False, False), (True, False), (False, True), (True, True)]
BULK_ZQ = (10.0, 2.0)
# kernel 17's seeded systems: depths 1, 2, the closures' 15, 30 and the
# class's 128 on (Mj, Li) planes whose column counts no block size divides
TRIDIAG_DEPTHS = (1, 2, 15, 30, 128)
TRIDIAG_PLANES = ((13, 41), (21, 47))
# kernel 2's tracer counts: one, the apps' two, and five (three groups of
# csrc/tadv.cu's two tracers a block, the last with one)
TADV_NT = (1, 2, 5)
# the column sweeps of kernels 6, 14 and 15: REDESIGN_SHAPES and the
# minimal depth N = 2 on a 4-lane channel
COLUMN_SHAPES = REDESIGN_SHAPES + [("upwelling", (2, 2, 2))]
# spline_vdiff's (NT, NAT): one, two and five tracers diffused with one or
# two Akt profiles (tracers past NAT take the last one's)
VDIFF_TRACERS = [(NT, NAT) for NT in (1, 2, 5) for NAT in (1, 2)]
# kernel 12's (app, (Lm, Mm)): the full-width BENCHMARK3 and UPWELLING
# planes, a ragged channel whose last row tile has one row in both types
# (Mj = 1601: 40 tiles of 40 rows and one of one in float32, 100 of 16
# and one of one in float64), and the 4- and 5-lane channels of Mj = 4
# and 5
BLOCKED_SHAPES = [("benchmark", (2048, 256)), ("upwelling", (512, 1024)),
                  ("upwelling", (38, 1599)), ("upwelling", (2, 2)),
                  ("upwelling", (2, 3)), ("upwelling", (3, 2)),
                  ("upwelling", (3, 3))]


def with_tracers(torch, args, NT):
    """A tadv entry point's args with NT tracers made from the app's two."""
    cfg, grid, q, aux = args[:4]
    qs = torch.stack([q[n % 2] * (1.0 + 0.1 * n) for n in range(NT)])
    auxs = torch.stack([aux[n % 2] for n in range(NT)])
    return (cfg.replace(NT=NT), grid, qs, auxs) + args[4:]


def vdiff_tracers(torch, args, NT, NAT):
    """A spline_vdiff entry point's args with NT tracers made from the
    app's and NAT Akt profiles (the n-th 1 + n/2 times the first)."""
    cfg, pre, Hz, Akt = args
    pres = torch.stack([pre[n % pre.shape[0]] * (1.0 + 0.1 * n)
                        for n in range(NT)])
    Akts = torch.stack([Akt[0] * (1.0 + 0.5 * n) for n in range(NAT)])
    return cfg.replace(NT=NT), pres, Hz, Akts


def column_cases(torch, env):
    """prep's and KPP's args on one app's seeded state whose tracer
    columns are turned upside down in every other column (statically
    unstable there, so no critical Richardson number is crossed); KPP
    alone takes the EOS of the same tracers."""
    from roms_tpu_torch.ops import rho as rho_op
    args, _ = entry_inputs(torch, "prep", *env, 5)
    cfg, t, z_r, Hz, z_w, u_r, v_r, *planes = args
    Mj, Li = t.shape[2:]
    col = torch.arange(Mj * Li, device=t.device).reshape(Mj, Li)
    t = torch.where(col % 2 == 0, t.flip(1), t)
    _, pden, _, _, bvf = rho_op.rho_eos_plain(cfg, t, z_r, Hz, z_w)
    return {"prep": (cfg, t, z_r, Hz, z_w, u_r, v_r, *planes),
            "kpp": (cfg, u_r, v_r, pden, bvf, Hz, z_w, *planes)}


def redesign_cases(torch, env):
    """(name, sides, iic, NT, args) of the redesigned kernels 2, 3, 4 and
    5 on one app's seeded state: the app's lanes and closed walls, tadv's
    predictor and uv_solve from iic 0, 1 and 5, tadv at TADV_NT."""
    from roms_tpu_torch.config import LBC, BoundaryConfig
    for name in ("tadv_predictor", "tadv_corrector", "rhs3d_momentum",
                 "uv_solve", "uv_finish"):
        for iic in (0, 1, 5) if name in ("tadv_predictor", "uv_solve") \
                else (5,):
            args, _ = entry_inputs(torch, name, *env, iic)
            for sides in ("app", "closed"):
                if sides == "closed":
                    args = (args[0].replace(
                        bc=BoundaryConfig.uniform(LBC())),) + args[1:]
                for NT in TADV_NT if name.startswith("tadv") else (2,):
                    yield name, sides, iic, NT, (
                        with_tracers(torch, args, NT)
                        if name.startswith("tadv") else args)


def bitwise(rel):
    """The note a redesign line ends with: a result that is not bitwise
    equal to its plain version is printed as such (FAILURES takes it only
    past TOL)."""
    return "bitwise" if rel == 0.0 else "NOT bitwise"


def redesign_checks(torch):
    """Kernels 2, 3, 4 and 5 at REDESIGN_SHAPES with the app's lanes and
    with closed walls, tadv's predictor and uv_solve from iic 0, 1 and 5,
    tadv at one, two and five tracers; kernels 9 and 10 at PRSGRD_SHAPES;
    kernels 7 and 8 at FLUX_SHAPES, kernel 13 on BULK_PLANES (bulk_cases)
    and kernel 17 on seeded systems of TRIDIAG_DEPTHS (all bitwise);
    kernels 6, 14 and 15 at COLUMN_SHAPES (spline_vdiff at VDIFF_TRACERS,
    bitwise; KPP's boundary layer column by column, both forcing regimes
    and columns with and without a crossing); kernel 12 at BLOCKED_SHAPES
    (bitwise against kernel 11); the float64 launches over shared memory
    refused."""
    from roms_tpu_torch.ops import (_lib, flux, kpp, prsgrd, rhs3d, step2d,
                                    tadv, uv, uvmix, vdiff)
    for app, (Lm, Mm, N) in REDESIGN_SHAPES:
        for dtype in ("float64", "float32"):
            env = setup(torch, Lm, Mm, N, dtype, app=app)
            for name, sides, iic, NT, args in redesign_cases(torch, env):
                rel, abs_err = compare(torch, name, args, dtype)
                print(f"kernel redesign {app:11s} {name:15s} {dtype} "
                      f"{sides:6s} N={N} Mj={Mm + 2} Li={Lm + 2} NT={NT} "
                      f"iic={iic}: max rel {rel:.3e} max abs {abs_err:.3e} "
                      f"{bitwise(rel)}", flush=True)
            del env
    for app, (Lm, Mm, N) in PRSGRD_SHAPES:
        for dtype in ("float64", "float32"):
            env = setup(torch, Lm, Mm, N, dtype, app=app)
            for name in ("prsgrd32", "uv3dmix2_s"):
                args, _ = entry_inputs(torch, name, *env, 5)
                rel, abs_err = compare(torch, name, args, dtype)
                print(f"kernel redesign {app:11s} {name:15s} {dtype} app    "
                      f"N={N} Mj={Mm + 2} Li={Lm + 2}: max rel {rel:.3e} max "
                      f"abs {abs_err:.3e} {bitwise(rel)}", flush=True)
            del env
    for app, (Lm, Mm, N) in FLUX_SHAPES:
        for dtype in ("float64", "float32"):
            env = setup(torch, Lm, Mm, N, dtype, app=app)
            args, _ = entry_inputs(torch, "flux_omega", *env, 5)
            rel, abs_err = compare(torch, "flux_omega", args, dtype)
            print(f"kernel redesign {app:11s} flux_omega      {dtype} app    "
                  f"N={N} Mj={Mm + 2} Li={Lm + 2}: max rel {rel:.3e} max "
                  f"abs {abs_err:.3e} {bitwise(rel)}", flush=True)
            if rel:
                FAILURES.append(f"flux_omega {dtype} {app} N={N} Mj={Mm + 2}"
                                f" Li={Lm + 2}: max rel {rel:.3e}, not "
                                "bitwise equal to its plain version")
            args, _ = entry_inputs(torch, "omega", *env, 5)
            before = _lib.launches["omega"]
            rel, abs_err = compare(torch, "omega", args, dtype)
            print(f"kernel redesign {app:11s} omega           {dtype} app    "
                  f"N={N} Mj={Mm + 2} Li={Lm + 2}: max rel {rel:.3e} max "
                  f"abs {abs_err:.3e} {bitwise(rel)}", flush=True)
            if rel or _lib.launches["omega"] != before + 1:
                FAILURES.append(f"omega {dtype} {app} N={N} Mj={Mm + 2} Li="
                                f"{Lm + 2}: max rel {rel:.3e}, launches "
                                f"{_lib.launches['omega'] - before}; want "
                                "bitwise, one launch")
            del env
    for dtype in ("float64", "float32"):
        for label, args in bulk_cases(torch, dtype):
            before = _lib.launches["bulk_flux"]
            rel, abs_err = compare(torch, "bulk_flux", args, dtype)
            print(f"kernel redesign benchmark   bulk_flux       {dtype} "
                  f"{label}: max rel {rel:.3e} max abs {abs_err:.3e} "
                  f"{bitwise(rel)}", flush=True)
            if rel or _lib.launches["bulk_flux"] != before + 1:
                FAILURES.append(f"bulk_flux {dtype} {label}: max rel "
                                f"{rel:.3e}, launches "
                                f"{_lib.launches['bulk_flux'] - before}; "
                                "want bitwise, one launch")
    for N in TRIDIAG_DEPTHS:
        for dtype in ("float64", "float32"):
            for Mj, Li in TRIDIAG_PLANES:
                args = tridiag_system(torch, N, Mj, Li, dtype)
                rel, abs_err = compare(torch, "tridiag", args, dtype)
                print(f"kernel redesign seeded     tridiag         {dtype} "
                      f"N={N} Mj={Mj} Li={Li}: max rel {rel:.3e} max abs "
                      f"{abs_err:.3e} {bitwise(rel)}", flush=True)
                if rel:
                    FAILURES.append(f"tridiag {dtype} N={N} Mj={Mj} Li={Li}: "
                                    f"max rel {rel:.3e}, not bitwise equal "
                                    "to its plain version")
    for app, (Lm, Mm, N) in COLUMN_SHAPES:
        for dtype in ("float64", "float32"):
            env = setup(torch, Lm, Mm, N, dtype, app=app)
            for name, args in column_cases(torch, env).items():
                rel, abs_err = compare(torch, name, args, dtype)
                print(f"kernel redesign {app:11s} {name:15s} {dtype} app    "
                      f"N={N} Mj={Mm + 2} Li={Lm + 2}: max rel {rel:.3e} "
                      f"max abs {abs_err:.3e} {bitwise(rel)}", flush=True)
                hsbl_check(torch, name, args, dtype,
                           label=f"kernel redesign {app:11s}", regimes=True)
            args, _ = entry_inputs(torch, "spline_vdiff", *env, 5)
            for NT, NAT in VDIFF_TRACERS:
                rel, abs_err = compare(torch, "spline_vdiff", vdiff_tracers(
                    torch, args, NT, NAT), dtype)
                print(f"kernel redesign {app:11s} spline_vdiff    {dtype} "
                      f"app    N={N} Mj={Mm + 2} Li={Lm + 2} NT={NT} "
                      f"NAT={NAT}: max rel {rel:.3e} max abs {abs_err:.3e} "
                      f"{bitwise(rel)}", flush=True)
                if rel:
                    FAILURES.append(f"spline_vdiff {dtype} {app} N={N} NT="
                                    f"{NT} NAT={NAT}: max rel {rel:.3e}, not "
                                    "bitwise equal to its plain version")
            del env
    for dtype in ("float64", "float32"):
        for label, args in blocked_cases(torch, dtype):
            rel, abs_err, same = blocked_check(torch, args, dtype)
            print(f"kernel redesign {label} fast_loop_blocked {dtype}: max "
                  f"rel {rel:.3e} max abs {abs_err:.3e} against the plain "
                  f"loop; against kernel 11 {bitwise(0.0 if same else 1.0)}",
                  flush=True)
            if not same:
                FAILURES.append(f"fast_loop_blocked {dtype} {label}: not "
                                "bitwise equal to kernel 11")
    env = setup(torch, 10, 8, 120, "float64", app="upwelling")
    args, _ = entry_inputs(torch, "uv_solve", *env, 5)
    refusals = [("uv_solve N=120", lambda: uv.uv_solve(*args))]
    env = setup(torch, 126, 62, 3, "float64", app="upwelling")
    args3, _ = entry_inputs(torch, "rhs3d_momentum", *env, 5)

    argsp, _ = entry_inputs(torch, "prsgrd32", *env, 5)
    argst, _ = entry_inputs(torch, "tadv_corrector", *env, 5)
    argsm, _ = entry_inputs(torch, "uv3dmix2_s", *env, 5)

    def big_tile(mod, call, args):
        def run():
            tile = mod.TILE
            mod.TILE = (64, 128)
            try:
                return call(*args)
            finally:
                mod.TILE = tile
        return run
    refusals += [
        ("rhs3d_momentum tile (64, 128)",
         big_tile(rhs3d, rhs3d.rhs3d_momentum, args3)),
        ("tadv_corrector tile (64, 128)",
         big_tile(tadv, tadv.corrector, argst)),
        ("prsgrd32 tile (64, 128)", big_tile(prsgrd, prsgrd.prsgrd32, argsp)),
        ("uv3dmix2_s tile (64, 128)", big_tile(uvmix, uvmix.uv3dmix2_s,
                                               argsm))]
    # kernel 12 in float64 with the float32 tile's window
    env = setup(torch, 126, 62, 3, "float64", app="upwelling")
    argsb, _ = entry_inputs(torch, "fast_loop_blocked", *env, 5)

    def blocked_big():
        tile = step2d.TILE_BLOCKED[8]
        step2d.TILE_BLOCKED[8] = step2d.TILE_BLOCKED[4]
        try:
            return step2d.fast_loop_blocked(*argsb)
        finally:
            step2d.TILE_BLOCKED[8] = tile
    refusals.append((f"fast_loop_blocked tile {step2d.TILE_BLOCKED[4]}",
                     blocked_big))
    # the column sweeps at the shallowest float64 depth whose state
    # exceeds a block's shared memory
    for name, smem_of, call in (
            ("uv_finish", lambda n: uv.finish_launch_shape(
                n, 10, 12, 8)[2], uv.uv_finish),
            ("spline_vdiff", lambda n: vdiff.vdiff_launch_shape(
                n, 2, 10, 12, 8)[2], vdiff.spline_vdiff),
            ("prep", lambda n: kpp.prep_launch_shape(n, 10, 12, 8)[2],
             entry_fns("prep")[0]),
            ("kpp", lambda n: kpp.prep_launch_shape(n, 10, 12, 8)[2],
             kpp.kpp)):
        N = 2
        while smem_of(N) <= _lib.SMEM_PER_BLOCK:
            N += 1
        env = setup(torch, 10, 8, N, "float64", app="benchmark")
        deep, _ = entry_inputs(torch, name, *env, 5)
        refusals.append((f"{name} N={N}", lambda c=call, a=deep: c(*a)))
    # flux_omega's running sums at the shallowest float64 depth over a
    # block's shared memory, on a grid of two 7 x 31 tiles
    N = flux_refused_depth(14, 31)
    env = setup(torch, 29, 12, N, "float64", app="benchmark")
    deep, _ = entry_inputs(torch, "flux_omega", *env, 5)
    refusals.append((f"flux_omega N={N}", lambda a=deep: flux.flux_omega(*a)))
    # omega's, on the same grid
    N = flux_refused_depth(14, 31, with_flux=False)
    env = setup(torch, 29, 12, N, "float64", app="benchmark")
    deep_w, _ = entry_inputs(torch, "omega", *env, 5)
    refusals.append((f"omega N={N}", lambda a=deep_w: flux.omega(*a)))
    for what, call in refusals:
        try:
            call()
        except ValueError as exc:
            print(f"kernel float64 {what}: refused ({exc})", flush=True)
        else:
            FAILURES.append(f"{what} float64: launched over shared memory")
    del env


def flux_refused_depth(Mj, Li, with_flux=True, itemsize=8):
    """The shallowest depth whose flux_omega (or, `with_flux=False`, omega)
    launch on an (Mj, Li) grid needs more shared memory than a block
    has."""
    from roms_tpu_torch.ops import _lib, flux
    N = 1
    while flux.launch_shape(N, Mj, Li, itemsize,
                            with_flux)[3] <= _lib.SMEM_PER_BLOCK:
        N += 1
    return N


def bulk_cases(torch, dtype, planes=None):
    """(label, args) of kernel 13 on BULK_PLANES (or `planes`): each
    plane's seeded atmosphere with every flag pair of BULK_FLAGS and
    blk_zq of BULK_ZQ; fails unless both stability regimes (air colder
    and warmer than the sea) are seeded on every plane."""
    for Lm, Mm in planes or BULK_PLANES:
        env = setup(torch, Lm, Mm, 2, dtype, app="benchmark")
        args, _ = entry_inputs(torch, "bulk_flux", *env, 5)
        cfg, atm, sst = args[:3]
        unstable = int((atm.Tair < sst).sum())
        if not 0 < unstable < sst.numel():
            fail(f"bulk_flux {dtype} Mj={Mm + 2} Li={Lm + 2}: the seeded "
                 f"atmosphere misses a stability regime ({unstable} of "
                 f"{sst.numel()} points unstable)")
        for (cool, c35), zq in [(f, z) for f in BULK_FLAGS for z in BULK_ZQ]:
            c = cfg.replace(blk_zq=zq)
            yield (f"Mj={Mm + 2} Li={Lm + 2} cool_skin={int(cool)} "
                   f"coare35={int(c35)} zq={zq:g} (zt={c.blk_zt:g}; "
                   f"{unstable} points unstable)",
                   (c, *args[1:], cool, c35))
        del env


def bulk_alone(torch):
    """The device kernels one bulk_flux call launches on BENCHMARK3's
    plane, from torch.profiler: only csrc/bulk.cu's (no PyTorch
    operation in the wrapper)."""
    from torch.profiler import ProfilerActivity, profile
    env = setup(torch, *BULK_PLANES[0], 2, "float32", app="benchmark")
    args, _ = entry_inputs(torch, "bulk_flux", *env, 5)
    kern = entry_fns("bulk_flux")[0]
    kern(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kern(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    print(f"kernel redesign benchmark   bulk_flux       float32 device "
          f"kernels of one call: {[n[:60] for n in names]}", flush=True)
    if not names or any("bulk" not in n and "stagger_kernel" not in n
                        for n in names):
        FAILURES.append(f"bulk_flux: the wrapper launched {names}")
    del env


def tridiag_system(torch, N, Mj, Li, dtype, seed=11):
    """Seeded diagonally dominant tridiagonal systems (lower, diag, upper,
    rhs) of N levels on an (Mj, Li) plane, made on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shp = (N, Mj, Li)

    def rnd():
        return torch.randn(shp, generator=gen, device=DEVICE,
                           dtype=getattr(torch, dtype))
    lower, upper = 0.5 * rnd(), 0.5 * rnd()
    diag = 2.0 + lower.abs() + upper.abs() + rnd().abs()
    return lower, diag, upper, rnd()


def engine_diff(torch, args):
    """Max relative difference of the j-blocked fast loop from the
    resident one on the same inputs, over the 16 carry fields."""
    from roms_tpu_torch.ops import step2d
    a = outputs(step2d.fast_loop_blocked(*args))
    b = outputs(step2d.fast_loop_res(*args))
    return max(float((x - y).abs().max() / (y.abs().max() + 1e-300))
               for x, y in zip(a, b))


def blocked_cases(torch, dtype, shapes=None, iics=(0, 1, 5)):
    """(label, args) of kernel 12 at BLOCKED_SHAPES (or `shapes`) from each
    of `iics`, on seeded zonally varying fast-loop inputs (N = 4; the
    app's nfast: 29 on BENCHMARK3, 42 on the channel)."""
    for app, (Lm, Mm) in shapes or BLOCKED_SHAPES:
        env = setup(torch, Lm, Mm, 4, dtype, app=app)
        for iic in iics:
            args, _ = entry_inputs(torch, "fast_loop_blocked", *env, iic)
            yield (f"{app:11s} Mj={Mm + 2} Li={Lm + 2} nfast={args[2]} "
                   f"iic={iic}"), args
        del env


def blocked_check(torch, args, dtype):
    """Kernel 12 against its plain loop (compare; one launch per chunk) and
    against kernel 11 on the same inputs: (max rel, max abs, bitwise equal
    to kernel 11)."""
    from roms_tpu_torch.ops import _lib, step2d
    before = _lib.launches["fast_loop_blocked"]
    rel, abs_err = compare(torch, "fast_loop_blocked", args, dtype)
    n = _lib.launches["fast_loop_blocked"] - before
    if n != len(step2d.chunk_schedule(args[2])):
        FAILURES.append(f"fast_loop_blocked: {n} launches for nfast "
                        f"{args[2]}")
    a = outputs(step2d.fast_loop_blocked(*args))
    b = outputs(step2d.fast_loop_res(*args))
    return rel, abs_err, all(torch.equal(x, y) for x, y in zip(a, b))


def closure_systems(torch, app, Lm, Mm, N, dtype):
    """The tridiagonal systems (lower, diag, upper, rhs) that the second
    step of the app's model solves from a zonally varying state: under
    GLS/MY2.5 two spline shear solves and the two turbulence solves, on
    the whole-array LMD route the eight spline solves of the interior
    shear and the two boundary layers."""
    from roms_tpu_torch.ops import tridiag
    model, s = make_model(torch, app, Lm, Mm, N, dtype, True,
                          APPS[app]["dt"], True)
    s = model.step(s)
    seen = []
    solve = tridiag.tridiag_solve

    def spy(*args):
        seen.append(args[:4])
        return solve(*args)
    tridiag.tridiag_solve = spy
    try:
        model.step(s)
    finally:
        tridiag.tridiag_solve = solve
    return seen


# --------------------------------------------------------------------------
# slice parity and full width
# --------------------------------------------------------------------------

def make_model(torch, app, Lm, Mm, N, dtype, use_kernels, dt, perturb):
    """Model and initial state; `perturb` adds seeded zonally varying
    noise to u, v and t (keeping the app's own zeta, u and v, such as
    CHANNEL's jet), so EW-periodic seam errors cannot cancel: 0.05 m/s
    in u and v unless the app's spec sets its "noise"."""
    from roms_tpu_torch.core.state import initial_state
    from roms_tpu_torch.core.stepping import Model
    cfg, grid, s, kw = app_setup(app, Lm, Mm, N, dtype, dt)
    if perturb:
        gen = torch.Generator(device=DEVICE).manual_seed(11)
        shp3 = (cfg.N,) + cfg.shape2d

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=DEVICE,
                               dtype=grid.dtype)
        un = APPS[app].get("noise", 0.05)
        s = initial_state(cfg, grid, zeta=s.zeta,
                          u=s.u + un * rnd(*shp3) * grid.umask,
                          v=s.v + un * rnd(*shp3) * grid.vmask,
                          t=s.t + 0.1 * rnd(*s.t.shape))
    return Model(cfg, grid, use_kernels=use_kernels,
                 fast_loop=APPS[app].get("fast_loop", "resident"), **kw), s


def slice_parity(torch, app):
    from roms_tpu_torch.ops import _lib
    Lm, Mm, N, dt = APPS[app]["parity"]
    perturb = app != "double_gyre"
    model, s = make_model(torch, app, Lm, Mm, N, "float64", False, dt,
                          perturb)
    a = model.run(s, 5)
    counts = dict(_lib.launches)
    if any(counts.values()):
        fail(f"use_kernels=False launched kernels: {counts}")
    model, s = make_model(torch, app, Lm, Mm, N, "float64", True, dt,
                          perturb)
    b = model.run(s, 5)
    per_step = APPS[app].get("per_step", {})
    for name, n in _lib.launches.items():
        want = 5 * per_step.get(name, 1) \
            if name in APPS[app]["entries"] else 0
        if n != want:
            fail(f"{app} parity: {name} launched {n} times in 5 steps, "
                 f"expected {want}")
    pairs = [(f, getattr(a, f), getattr(b, f))
             for f in ("zeta", "ubar", "vbar", "u", "v", "t")]
    if a.mix is not None:
        pairs += [(f, getattr(a.mix, f), getattr(b.mix, f))
                  for f in a.mix._fields]
    same = True
    for f, x, y in pairs:
        if not torch.isfinite(y).all():
            fail(f"{app} slice parity: {f} not finite")
        d = float((x - y).abs().max())
        scale = float(x.abs().max())
        same = same and torch.equal(x, y)
        print(f"{app} slice parity {f:8s}: max|diff| {d:.3e}  max|x| "
              f"{scale:.3e}", flush=True)
        if d >= 1e-10 * scale + 5e-14:
            fail(f"{app} slice parity {f}: {d:.3e} vs {scale:.3e}")
    print(f"{app} slice parity: kernel path "
          f"{'bitwise equal' if same else 'NOT bitwise equal'} to "
          f"use_kernels=False over every field", flush=True)
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


def full_width(torch, app):
    """The app's full-width float32 run; returns each entry point's
    launches in its 10 measured steps."""
    from roms_tpu_torch.ops import _lib, step2d
    Lm, Mm, N = APPS[app]["full"]
    nsteps = 10
    model, s = make_model(torch, app, Lm, Mm, N, "float32", True,
                          APPS[app]["dt"], False)
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
        fail(f"{app}: plain versions ran on the main path: {plain_calls}")
    ms_step = start.elapsed_time(end) / nsteps
    BARE_MS[app] = ms_step
    print(f"full width {app} {Mm + 2}x{Lm + 2}x{N} float32: {ms_step:.3f} "
          f"ms/step (CUDA events), host wall {1e3 * wall / nsteps:.3f} "
          f"ms/step, nfast={model.nfast} [{CARD}]", flush=True)
    per_call = step2d.HALF_STEPS * model.nfast \
        if counts["fast_loop_res"] else 0
    print(f"{app} launches in {nsteps} steps: {counts}; plain-version "
          f"calls: 0; fast loop CUDA launches per call: {per_call}",
          flush=True)
    per_step = APPS[app].get("per_step", {})
    for name, n in counts.items():
        want = nsteps * per_step.get(name, 1) \
            if name in APPS[app]["entries"] else 0
        if n != want:
            fail(f"{app} {name}: {n} launches in {nsteps} steps, expected "
                 f"{want}")
    for f in ("zeta", "ubar", "vbar", "u", "v", "t"):
        x = getattr(s, f)
        if not torch.isfinite(x).all():
            fail(f"full width {app}: {f} not finite")
    # the area-weighted interior mean (cell areas 1/(pm pn) vary with
    # latitude on the spherical BENCHMARK grid)
    zi = s.zeta[1:-1, 1:-1].double()
    area = (1.0 / (model.grid.pm * model.grid.pn))[1:-1, 1:-1].double()
    vol = float((zi * area).sum() / area.sum())
    zmax = float(zi.abs().max())
    print(f"{app} interior mean zeta {vol:.3e} (max|zeta| {zmax:.3e}), "
          f"max|u| {float(s.u.abs().max()):.3e}", flush=True)
    # float32 roundoff: the interior mean stays within eps32*max|zeta|
    if not abs(vol) <= 1.2e-7 * zmax:
        fail(f"{app}: interior volume not conserved to float32 roundoff")
    if APPS[app].get("mixing", {}).get("bkpp"):
        # the surface and bottom boundary layers of the last state, from
        # the write-time diagnostics (the step's own route), lie in the
        # water column
        d = model.diagnose(s)
        for name in ("hsbl", "hbbl"):
            h = d[name]
            out = int(((h < s.z_w[0]) | (h > s.z_w[-1])).sum())
            zbl = (s.z_w[-1] - h) if name == "hsbl" else (h - s.z_w[0])
            print(f"{app} {name} thickness {float(zbl.min()):.2f} to "
                  f"{float(zbl.max()):.2f} m, mean {float(zbl.mean()):.2f} "
                  f"m; columns outside [z_w[0], z_w[N]]: {out}",
                  flush=True)
            if out or not torch.isfinite(h).all():
                fail(f"{app}: {name} outside the water column")
    elif APPS[app].get("base", app) == "benchmark":
        # the boundary layer of the last state lies in the water column
        from roms_tpu_torch.ops import prep
        from roms_tpu_torch.ops.prep import surface_rho
        forcing = model.forcing_fn(s.time, s.t[0][-1], s.t[1][-1],
                                   surface_rho(model.cfg, s.t, s.z_r))
        hsbl = prep.prep_fused(model.cfg, model.grid, s.t, s.u, s.v, s.Hz,
                               s.z_r, s.z_w, forcing)[-1]
        below = int((hsbl < s.z_w[0]).sum())
        above = int((hsbl > s.z_w[-1]).sum())
        zbl = s.z_w[-1] - hsbl
        print(f"benchmark KPP boundary layer depth: {float(zbl.min()):.2f}"
              f" to {float(zbl.max()):.2f} m, mean {float(zbl.mean()):.2f}"
              f" m; columns outside [z_w[0], z_w[N]]: {below + above}",
              flush=True)
        if below + above or not torch.isfinite(hsbl).all():
            fail("benchmark: KPP boundary layer outside the water column")
    if s.mix is not None:
        closure_floors(torch, app, model.cfg, s.mix)
    if app.startswith("upwelling"):
        # x-uniform initial state and wind: zeta stays x-uniform
        xu = float((s.zeta - s.zeta[:, :1]).abs().max())
        print(f"upwelling zeta x-uniformity max|zeta - zeta[:, 0]| "
              f"{xu:.3e}", flush=True)
        if not xu <= 1e-5 * zmax:
            fail("upwelling: zeta lost its x-uniformity")
    timing_windows(torch, app, model, s, nsteps)
    if APPS[app].get("fast_loop") == "blocked":
        engine_split(torch, app, model, s)
    return counts


def engine_split(torch, app, model, s, nsteps=3):
    """The fast loop's own time inside the step under each engine, in
    turns (resident, blocked, blocked, resident): CUDA events around the
    model's fast loop over `nsteps` steps, beside the step's time."""
    from roms_tpu_torch.core.step2d import make_fast_loop
    from roms_tpu_torch.core.weights import power_law_weights
    nfast, w1, w2 = power_law_weights(model.cfg.ndtfast)
    loops = {"blocked": model.fast_loop,
             "resident": make_fast_loop(model.cfg, nfast, w1, w2,
                                        engine="resident")}
    for engine in ("resident", "blocked", "blocked", "resident"):
        inner = loops[engine]
        marks = []

        def timed(*args, _inner=inner):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = _inner(*args)
            b.record()
            marks.append((a, b))
            return out
        model.fast_loop = timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        s = model.run(s, nsteps)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / nsteps
        fl = sum(a.elapsed_time(b) for a, b in marks) / nsteps
        print(f"{app} {engine:8s} engine: step {step_ms:.3f} ms, fast loop "
              f"{fl:.3f} ms ({nfast} substeps), rest {step_ms - fl:.3f} ms "
              f"[{CARD}]", flush=True)
    model.fast_loop = loops["blocked"]


def timing_windows(torch, app, model, s, nsteps, windows=3):
    """The step's spread within one call: `windows` more runs of
    `nsteps` steps, each with its CUDA-event time, the host's time to
    issue the run (until `run` returns) and its wall time (until the
    card is done), then one more run with the card's SM clock, power and
    temperature read by nvidia-smi while it runs."""
    for w in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        s = model.run(s, nsteps)
        end.record()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{app} window {w}: {start.elapsed_time(end) / nsteps:.3f} "
              f"ms/step (CUDA events), host issue {1e3 * issued / nsteps:.3f}"
              f" ms/step, host wall {1e3 * wall / nsteps:.3f} ms/step "
              f"[{CARD}]", flush=True)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    s = model.run(s, nsteps)
    torch.cuda.synchronize()
    out = smi.communicate()[0].strip()
    print(f"{app} card during a further {nsteps} steps (SM clock, max SM "
          f"clock, power, temperature): {out}", flush=True)


def closure_floors(torch, app, cfg, mix):
    """The turbulence fields of a GLS/MY2.5 run are finite and at or
    above the closure's floors (gls_kmin/gls_pmin, MY2.5's QMIN) and
    Akv at or above its background."""
    from roms_tpu_torch.core.my25 import QMIN
    m = cfg.mixing
    for f in mix._fields:
        if not torch.isfinite(getattr(mix, f)).all():
            fail(f"full width {app}: mix.{f} not finite")
    kmin, pmin = (QMIN, QMIN) if m.vmix == "my25" else (m.gls_kmin,
                                                         m.gls_pmin)
    print(f"{app} tke {float(mix.tke.min()):.3e}..{float(mix.tke.max()):.3e}"
          f" (floor {kmin:.1e}), gls {float(mix.gls.min()):.3e}.."
          f"{float(mix.gls.max()):.3e} (floor {pmin:.1e}), Akv "
          f"{float(mix.Akv.min()):.3e}..{float(mix.Akv.max()):.3e} "
          f"(background {m.akv_bak:.1e})", flush=True)
    if not (bool((mix.tke >= kmin).all()) and bool((mix.gls >= pmin).all())
            and bool((mix.Akv >= m.akv_bak).all())):
        fail(f"{app}: turbulence fields below the closure's floors")


def sass_functions(obj):
    """{demangled kernel name: [(address, instruction)]} of an object
    file's SASS (`cuobjdump -sass`), or None where the toolkit has no
    cuobjdump."""
    import shutil
    from pathlib import Path
    from roms_tpu_torch.ops import _lib
    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True).stdout
    return parse_sass(text, _lib._demangle)


def parse_sass(text, demangle=str):
    """{kernel name: [(address, instruction)]} of `cuobjdump -sass` text."""
    import re
    funcs, body = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            body = funcs.setdefault(demangle(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m and body is not None:
            body.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_paths(code):
    """(shortest, longest or None, instructions) of one kernel's SASS
    from its entry through a global store to an EXIT: warp instructions
    along the path with the fewest (a static count; calls to the
    slow-path subroutines of IEEE division, square root and the like
    count one), along the longest where no loop is reachable, and in the
    whole function."""
    import heapq
    import re
    at = {addr: n for n, (addr, _) in enumerate(code)}

    def step(n):
        # (successors, whether a path may end at n)
        ins = code[n][1]
        guard = ins.split()[0] if ins.startswith("@") else ""
        op = ins.split()[1 if guard else 0]
        nxt = [n + 1] if n + 1 < len(code) else []
        if guard == "@!PT":
            return nxt, False
        pred = guard not in ("", "@PT")
        if op.startswith(("EXIT", "RET")):
            return (nxt if pred else []), True
        if op.startswith("BRA"):
            tgt = at.get(int(re.findall(r"0x[0-9a-f]+", ins)[-1], 16))
            if tgt is not None:
                return ([tgt] + nxt if pred else [tgt]), False
        return nxt, False
    # states (instruction, whether a global store was passed): a path
    # counts once it has stored, so a thread past the grid's last point
    # (an early EXIT) is no path
    dist, heap, best = {(0, False): 1}, [(1, 0, False)], None
    reach = set()
    while heap:
        d, n, stored = heapq.heappop(heap)
        if d > dist[(n, stored)]:
            continue
        reach.add(n)
        stored = stored or " STG" in " " + code[n][1]
        nxt, ends = step(n)
        if ends and stored:
            best = d if best is None else min(best, d)
        for m in nxt:
            if d + 1 < dist.get((m, stored), 1 << 30):
                dist[(m, stored)] = d + 1
                heapq.heappush(heap, (d + 1, m, stored))
    far = None
    if all(m > n for n in reach for m in step(n)[0]):
        longest = {}
        for n in sorted(reach, reverse=True):
            nxt, ends = step(n)
            tails = [longest[m] for m in nxt if m in longest]
            if tails or ends:
                longest[n] = 1 + max(tails, default=0)
        far = longest.get(0)
    return best, far, len(code)


def issue_floor(torch, points):
    """Kernel 13's issue floor at `points` points: the warp instructions a
    point along the shortest path through the float32 kernels of the
    main path (bulk_kernel<float, true>, blk_zt == blk_zq, and
    stagger_kernel<float>), times the points' warps, over 4 schedulers x
    132 SMs x the card's highest SM clock (nvidia-smi, this call).
    Returns (ms, text) or (None, text)."""
    from roms_tpu_torch.ops import _lib
    funcs = sass_functions(_lib.build_dir / "bulk.o")
    if funcs is None:
        return None, "cuobjdump not found: issue floor not measured"
    found = {}
    for name, code in funcs.items():
        for key in ("bulk_kernel<float, true>", "stagger_kernel<float>"):
            if f"::{key}(" in name:
                found[key] = (sass_paths(code), code)
    if len(found) != 2:
        return None, f"SASS of {sorted(found)} only: issue floor not measured"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    if smi.returncode or not smi.stdout.strip():
        return None, "nvidia-smi gave no SM clock: issue floor not measured"
    mhz = float(smi.stdout.split()[0])
    per_point = sum(p[0] for p, _ in found.values())
    warps = -(-points // 32)
    ms = 1e3 * per_point * warps / (4 * 132 * mhz * 1e6)
    (short, far, total), code = found["bulk_kernel<float, true>"]
    mufu_all = sum(1 for _, ins in code if "MUFU" in ins)
    branches = sum(1 for _, ins in code
                   if ins.startswith("@") and " BRA" in ins)
    text = (f"bulk_kernel<float, true>: {short} warp instructions on its "
            f"shortest path (a static SASS count: a stable point without "
            f"cool skin, each IEEE division's slow path a call), {far} on "
            f"its longest (the unstable branches, cool skin and the slow "
            f"paths), {total} in the function, {branches} conditional "
            f"branches, {mufu_all} MUFU; stagger_kernel<float>: "
            f"{found['stagger_kernel<float>'][0][0]}; {per_point} a point x "
            f"{warps} warps / (4 x 132 x {mhz:g} MHz) -> issue floor "
            f"{ms:.4f} ms")
    return ms, text


def tridiag_library(torch, args, out):
    """torch.linalg.solve on the same systems built densely as a
    (Mj*Li, n, n) batch: the PyTorch call that computes the same
    solution.  Returns the call (the dense build is not timed)."""
    lower, diag, upper, rhs = args
    n, P = rhs.shape[0], rhs[0].numel()
    A = torch.zeros((P, n, n), dtype=rhs.dtype, device=rhs.device)
    k = torch.arange(n, device=rhs.device)
    A[:, k, k] = diag.reshape(n, P).T
    A[:, k[1:], k[:-1]] = lower[1:].reshape(n - 1, P).T
    A[:, k[:-1], k[1:]] = upper[:-1].reshape(n - 1, P).T
    B = rhs.reshape(n, P).T.unsqueeze(-1).contiguous()

    def call():
        return torch.linalg.solve(A, B)
    x = call()[..., 0].T.reshape(rhs.shape)
    torch.cuda.synchronize()
    mb = A.numel() * A.element_size() / 1e6
    print(f"  torch.linalg.solve vs the kernel: max rel "
          f"{float((x - out).abs().max() / out.abs().max()):.3e} "
          f"({P} dense {n}x{n} systems, {mb:.0f} MB)", flush=True)
    return call


def kernel_table(torch, app, counts):
    """Each of the app's entry points (and those checked off its path)
    timed at its full-width float32 shapes, beside its plain version's
    time and its bound, with its launches from the app's full-width run;
    rows of the kernels JSON."""
    Lm, Mm, N = APPS[app]["full"]
    env = setup(torch, Lm, Mm, N, "float32", app=app)
    table = []
    spec = APPS[app]
    for name in spec.get("checked", spec["entries"]) + \
            spec.get("off_path", []):
        src, rep = SOURCES[name]
        args, ins = entry_inputs(torch, name, *env, 5)
        rel, abs_err = compare(torch, name, args, "float32")
        if FAILURES:
            fail(FAILURES[-1])
        kern, plain = entry_fns(name)
        outs = outputs(kern(*args))
        byts = nbytes(ins) + nbytes(outs)
        if name == "prep":
            # Akt is written for each active tracer (outs has one profile)
            byts += (args[0].NAT - 1) * nbytes([outs[5]])
        npts = outs[0].numel()
        flops = FLOPS_PER_POINT[name] * npts
        if name.startswith("fast_loop"):
            flops *= args[2]
        t_bytes = 1e3 * byts / HBM_BYTES_PER_S
        t_ops = 1e3 * flops / FP32_FLOPS
        ms = cuda_ms(torch, lambda: kern(*args), 20)
        plain_ms = cuda_ms(torch, lambda: plain(*args), 3)
        library_ms = None
        if name == "tridiag":
            library_ms = cuda_ms(torch, tridiag_library(torch, args,
                                                        outs[0]), 3)
        if name == "bulk_flux":
            # the instructions it issues: an operations bound
            t_issue, text = issue_floor(torch, npts)
            print(f"{app} {text}", flush=True)
            t_ops = max(t_ops, t_issue or 0.0)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": counts[name],
               "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms}
        print(f"{app} {name:15s} {ms:9.4f} ms  plain {plain_ms:9.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{byts / 1e6:.1f} MB)  launches/step "
              f"{counts[name] / 10:g}  rel {rel:.2e}"
              + (f"  torch.linalg.solve {library_ms:.4f} ms"
                 if library_ms is not None else ""), flush=True)
        if name == "bulk_flux":
            # the wrapper's PyTorch part: the U/V staggering of the
            # stresses after the kernel
            from roms_tpu_torch.core.bulk_flux import stagger_stress
            stag_ms = cuda_ms(torch, lambda: stagger_stress(
                args[0], outs[0], outs[1]), 20)
            print(f"{app} bulk_flux stagger_stress alone {stag_ms:.4f} ms "
                  f"of the wrapper's {ms:.4f} ms", flush=True)
        if name == "fast_loop_res":
            # its own design's floor: the planes each launch moves once
            from roms_tpu_torch.ops.step2d import HALF_STEPS, \
                res_launch_shape
            nl = HALF_STEPS * args[2]
            plane = outs[0].numel() * outs[0].element_size()
            per = sum(FAST_LOOP_PLANES_PER_LAUNCH.values()) / 2 * plane
            TJ, TI, HJ, HI, blocks, smem = res_launch_shape(
                *outs[0].shape, outs[0].element_size())
            print(f"{app} fast_loop_res per launch: {ms / nl:.4f} ms over "
                  f"{nl} launches; {per / plane:g} planes, {per / 1e6:.1f} "
                  f"MB a launch -> {1e3 * per / HBM_BYTES_PER_S:.4f} ms, "
                  f"{nl * 1e3 * per / HBM_BYTES_PER_S:.4f} ms a call; tile "
                  f"{TJ}x{TI}, halo {HJ}/{HI}, {blocks} blocks, {smem} B "
                  f"dynamic shared memory a block", flush=True)
        if name == "rot_div_geo":
            from roms_tpu_torch.ops.hmix import launch_shape
            NT, N, Mj, Li = outs[0].shape
            TJ, TI, blocks, smem = launch_shape(NT, Mj, Li,
                                                outs[0].element_size())
            halo = (TJ + 2) * (TI + 2) / (TJ * TI)
            print(f"{app} rot_div_geo tile {TJ}x{TI}, {blocks} blocks, "
                  f"{smem} B dynamic shared memory a block; q, z_r and Hz "
                  f"read over windows {halo:.3f}x the tiles (halo from L2); "
                  f"the coefficient planes built in the kernel, no PyTorch "
                  f"operation in the wrapper", flush=True)
        if name == "rhs3d_momentum":
            from roms_tpu_torch.ops.rhs3d import launch_shape
            TJ, TI, halo, blocks, smem = launch_shape(
                *outs[0].shape[1:], outs[0].element_size())
            win = (TJ + 2 * halo) * (TI + 2 * halo) / (TJ * TI)
            print(f"{app} rhs3d_momentum tile {TJ}x{TI}, halo {halo}, "
                  f"{blocks} blocks, {smem} B dynamic shared memory a "
                  f"block; window {win:.3f}x the tile (halo from L2)",
                  flush=True)
        if name in ("tadv_predictor", "prsgrd32"):
            from roms_tpu_torch.ops import prsgrd, tadv
            shp = outs[0].shape
            TJ, TI, halo, blocks, smem = tadv.launch_shape(
                shp[0], *shp[2:], outs[0].element_size()) \
                if name == "tadv_predictor" else prsgrd.launch_shape(
                    *shp[1:], outs[0].element_size())
            hj = (halo, halo) if name == "tadv_predictor" else halo
            win = (TJ + sum(hj)) * (TI + sum(hj)) / (TJ * TI)
            print(f"{app} {name} tile {TJ}x{TI}, halo {halo}, {blocks} "
                  f"blocks, {smem} B dynamic shared memory a block; window "
                  f"{win:.3f}x the tile (halo from L2)", flush=True)
        if name in ("uv_solve", "uv_finish"):
            from roms_tpu_torch.ops import uv
            N, Mj, Li = outs[0].shape
            shape_of, vals = (uv.solve_launch_shape, 4 * N - 2) \
                if name == "uv_solve" else (uv.finish_launch_shape, 2 * N)
            B, blocks, smem = shape_of(N, Mj, Li, outs[0].element_size())
            print(f"{app} {name} {B} threads a block, {blocks} blocks (u "
                  f"and v), {smem} B dynamic shared memory a block "
                  f"({vals} values a thread)", flush=True)
        if name in ("flux_omega", "omega"):
            from roms_tpu_torch.ops import flux
            N, Mj, Li = outs[-1].shape
            N -= 1
            TJ, TI, blocks, smem = flux.launch_shape(
                N, Mj, Li, outs[0].element_size(), name == "flux_omega")
            win = (TJ + 2) * (TI + 2) / (TJ * TI) if name == "flux_omega" \
                else (TJ + 1) * (TI + 1) / (TJ * TI)
            print(f"{app} {name} tile {TJ}x{TI}, {blocks} blocks, {smem} "
                  f"B dynamic shared memory a block ({N - 1} levels of "
                  f"running sums); staged window {win:.3f}x the tile (halo "
                  f"from L2)", flush=True)
        if name == "tridiag":
            from roms_tpu_torch.ops import tridiag
            B, blocks, smem = tridiag.launch_shape(
                *outs[0].shape, outs[0].element_size())
            print(f"{app} tridiag {B} threads a block, {blocks} blocks, "
                  f"{smem} B dynamic shared memory a block (cp and dp, "
                  f"{2 * outs[0].shape[0]} values a thread)", flush=True)
        if name == "uv3dmix2_s":
            from roms_tpu_torch.ops import uvmix
            TJ, TI, blocks, smem = uvmix.launch_shape(
                *outs[0].shape[1:], outs[0].element_size())
            win = (TJ + 2) * (TI + 2) / (TJ * TI)
            print(f"{app} uv3dmix2_s tile {TJ}x{TI}, halo 1, {blocks} "
                  f"blocks, {smem} B dynamic shared memory a block; window "
                  f"{win:.3f}x the tile (halo from L2)", flush=True)
        if name in ("prep", "kpp", "spline_vdiff"):
            from roms_tpu_torch.ops import kpp as kpp_op
            from roms_tpu_torch.ops import vdiff as vdiff_op
            size = outs[0].element_size()
            if name == "spline_vdiff":
                NT, N, Mj, Li = outs[0].shape
                B, blocks, smem = vdiff_op.vdiff_launch_shape(
                    N, NT, Mj, Li, size)
                vals, how = 4 * N - 2, f"{NT} tracers"
            else:
                N, Mj, Li = outs[4 if name == "prep" else 0].shape
                N -= 1
                B, blocks, smem = kpp_op.prep_launch_shape(N, Mj, Li, size)
                vals, how = kpp_op.column_values(N), "the rest from L2"
            print(f"{app} {name} {B} threads a block, {blocks} blocks, "
                  f"{smem} B dynamic shared memory a block ({vals} values a "
                  f"thread, {how})", flush=True)
        if name == "fast_loop_blocked":
            # its own design's floor: each launch reads the carry (16
            # planes) and the statics (28) and writes the carry (16) once;
            # zeta, zeta_prev, ubar and vbar are read over the windows,
            # the statics' halo comes from L2, and the rhs histories stay
            # in device scratch (L2)
            from roms_tpu_torch.ops import _lib, step2d
            nl = len(step2d.chunk_schedule(args[2]))
            Mj, Li = outs[0].shape
            size = outs[0].element_size()
            per = (2 * 16 + 28) * outs[0].numel() * size
            TJ, TI, HJ, HI, blocks, smem = step2d.blocked_launch_shape(
                Mj, Li, size)
            slots = min(blocks, step2d.blocked_slots(
                _lib.suffix(outs[0].dtype), TJ, TI, HJ, HI))
            elems = step2d.blocked_scratch(TJ, TI, Li)
            win = (TJ + 2 * HJ) * (TI + 2 * HI) / (TJ * TI)
            print(f"{app} fast_loop_blocked per launch: {ms / nl:.4f} ms "
                  f"over {nl} launches; 60 planes, {per / 1e6:.1f} MB a "
                  f"launch -> {1e3 * per / HBM_BYTES_PER_S:.4f} ms, "
                  f"{nl * 1e3 * per / HBM_BYTES_PER_S:.4f} ms a call "
                  f"(design floor); tile {TJ}x{TI}, halo {HJ}/{HI}, window "
                  f"{win:.3f}x the tile, {step2d.BLOCKED_WIN_PLANES} window "
                  f"planes in {smem} B dynamic shared memory a block, "
                  f"{blocks} tiles on {slots} blocks", flush=True)
            print(f"{app} fast_loop_blocked device scratch: "
                  f"{slots * elems * size} B ({slots} blocks x {elems} "
                  f"elements x {size} B)", flush=True)
        table.append(row)
    del env
    torch.cuda.empty_cache()
    return table


def fast_loop_terms(torch, app):
    """Kernel 11's time at the app's full width with each term of the 2D
    momentum RHS switched off in turn (the pressure gradient, the
    updates and the fluxes stay): where the loop's time goes by term."""
    from roms_tpu_torch.ops import step2d
    env = setup(torch, *APPS[app]["full"], "float32", app=app)
    args, _ = entry_inputs(torch, "fast_loop_res", *env, 5)
    cfg = args[0]
    no_visc = dataclasses.replace(cfg.mixing, visc2=0.0)
    for name, c in (("all terms", cfg), ("no viscosity", cfg.replace(
            mixing=no_visc)), ("no advection", cfg.replace(uv_adv=False)),
                    ("no Coriolis", cfg.replace(uv_cor=False)),
                    ("none of the three", cfg.replace(
                        uv_adv=False, uv_cor=False, mixing=no_visc))):
        ms = cuda_ms(torch, lambda: step2d.fast_loop_res(c, *args[1:]), 5)
        print(f"{app} fast_loop_res {name}: {ms:.4f} ms [{CARD}]",
              flush=True)
    del env
    torch.cuda.empty_cache()


# the launch shapes timed against the chosen ones (ops/rhs3d.py TILE,
# ops/uv.py SOLVE_THREADS and FINISH_THREADS, ops/tadv.py TILE,
# ops/prsgrd.py TILE, ops/uvmix.py TILE, ops/kpp.py PREP_THREADS,
# ops/vdiff.py VDIFF_THREADS, ops/flux.py TILE, ops/tridiag.py THREADS,
# ops/bulk.py SHAPE;
# tridiag at the GLS/MY2.5 solves' shape, with the UPWELLING app)
RHS3D_TILES = ((8, 32), (16, 16), (4, 64), (8, 16))
UV_SOLVE_THREADS = (64, 96, 128, 192)
UV_FINISH_THREADS = (64, 96, 128, 192, 256)
UVMIX_TILES = ((7, 31), (15, 15), (3, 63), (7, 15), (3, 31))
TADV_TILES = ((7, 31), (8, 32), (15, 15), (16, 16), (4, 64))
PRSGRD_TILES = ((7, 31), (15, 15), (3, 63), (7, 15), (3, 31))
PREP_THREADS_TRIED = (32, 64, 96, 128)
VDIFF_THREADS_TRIED = (64, 96, 128, 192, 256)
FLUX_TILES = ((7, 31), (15, 15), (3, 63), (7, 15))
# ops/step2d.py TILE_BLOCKED[4]: kernel 12's float32 tiles whose window fits
# a block's shared memory
BLOCKED_TILES = ((40, 56), (24, 86), (32, 64), (20, 56), (16, 96))
TRIDIAG_THREADS_TRIED = (64, 128, 192, 256)
# ops/bulk.py SHAPE: threads a block of the bulk and staggering kernels
BULK_THREADS_TRIED = (128, 256, 512)


def launch_shapes(torch, app):
    """rhs3d's time with each tile of RHS3D_TILES (and with its advection
    or Coriolis term off), uv_solve's and uv_finish's with each block size
    of UV_SOLVE_THREADS and UV_FINISH_THREADS, tadv's (both modes) with
    each of TADV_TILES, prsgrd's and uvmix's with each of PRSGRD_TILES
    and UVMIX_TILES, and prep's and spline_vdiff's with each block size of
    PREP_THREADS_TRIED and VDIFF_THREADS_TRIED, flux_omega's and omega's
    with each of FLUX_TILES, bulk_flux's with each block size of
    BULK_THREADS_TRIED, tridiag's with each block size of
    TRIDIAG_THREADS_TRIED and kernel 12's with each tile of BLOCKED_TILES
    at the app's full width, float32, each output bitwise against the
    chosen shape's."""
    from roms_tpu_torch.ops import (bulk, flux, kpp, prsgrd, rhs3d, step2d,
                                    tadv, tridiag, uv, uvmix, vdiff)

    def tile_of(mod):
        return lambda: mod.TILE, lambda x: setattr(mod, "TILE", x)
    env = setup(torch, *APPS[app]["full"], "float32", app=app)
    for name, shapes, get, put in (
            ("rhs3d_momentum", RHS3D_TILES, *tile_of(rhs3d)),
            ("uv_solve", UV_SOLVE_THREADS, lambda: uv.SOLVE_THREADS[4],
             lambda x: uv.SOLVE_THREADS.__setitem__(4, x)),
            ("uv_finish", UV_FINISH_THREADS, lambda: uv.FINISH_THREADS[4],
             lambda x: uv.FINISH_THREADS.__setitem__(4, x)),
            ("uv3dmix2_s", UVMIX_TILES, *tile_of(uvmix)),
            ("tadv_predictor", TADV_TILES, *tile_of(tadv)),
            ("tadv_corrector", TADV_TILES, *tile_of(tadv)),
            ("prsgrd32", PRSGRD_TILES, *tile_of(prsgrd)),
            ("prep", PREP_THREADS_TRIED, lambda: kpp.PREP_THREADS[4],
             lambda x: kpp.PREP_THREADS.__setitem__(4, x)),
            ("spline_vdiff", VDIFF_THREADS_TRIED,
             lambda: vdiff.VDIFF_THREADS[4],
             lambda x: vdiff.VDIFF_THREADS.__setitem__(4, x)),
            ("flux_omega", FLUX_TILES, *tile_of(flux)),
            ("omega", FLUX_TILES, *tile_of(flux)),
            ("bulk_flux", BULK_THREADS_TRIED, lambda: bulk.SHAPE,
             lambda x: setattr(bulk, "SHAPE", x)),
            ("tridiag", TRIDIAG_THREADS_TRIED, lambda: tridiag.THREADS[4],
             lambda x: tridiag.THREADS.__setitem__(4, x)),
            ("fast_loop_blocked", BLOCKED_TILES,
             lambda: step2d.TILE_BLOCKED[4],
             lambda x: step2d.TILE_BLOCKED.__setitem__(4, x))):
        if name not in APPS[app]["entries"] and not (
                name == "tridiag" and app == "upwelling") and \
                name != "fast_loop_blocked":
            continue
        args, _ = entry_inputs(torch, name, *env, 5)
        kern = entry_fns(name)[0]
        chosen = get()
        ref = outputs(kern(*args))
        for shape in shapes:
            put(shape)
            try:
                same = all(torch.equal(a, b) for a, b in zip(
                    outputs(kern(*args)), ref))
                ms = cuda_ms(torch, lambda: kern(*args), 20)
            finally:
                put(chosen)
            print(f"{app} {name} launch shape {shape}"
                  f"{' (chosen)' if shape == chosen else ''}: {ms:.4f} ms "
                  f"[{CARD}]", flush=True)
            if not same:
                fail(f"{app} {name}: launch shape {shape} changed the output")
        if name == "rhs3d_momentum":
            cfg = args[0]
            for what, c in (("no advection", cfg.replace(uv_adv=False)),
                            ("no Coriolis", cfg.replace(uv_cor=False))):
                ms = cuda_ms(torch, lambda: kern(c, *args[1:]), 20)
                print(f"{app} rhs3d_momentum {what}: {ms:.4f} ms [{CARD}]",
                      flush=True)
    del env
    torch.cuda.empty_cache()


def profile_step(torch, app):
    """Breakdown of one full-width float32 step of `app`: the fast
    barotropic loop vs the rest (CUDA events over 3 steps), then
    torch.profiler's device time by kernel over one step (after a
    warm-up step under the profiler) and the device's idle share."""
    Lm, Mm, N = APPS[app]["full"]
    model, s = make_model(torch, app, Lm, Mm, N, "float32", True,
                          APPS[app]["dt"], False)
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
    print(f"{app} step {step_ms:.3f} ms: fast loop {fl:.3f} ms "
          f"({model.nfast} substeps), rest {step_ms - fl:.3f} ms",
          flush=True)
    model.fast_loop = inner

    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    # the tracer drops the first kernel it sees (each step's flux_omega
    # went unrecorded), so a warm-up step runs under it first and only
    # the second step is recorded
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        s = model.step(s)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        s = model.step(s)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device rows, without the schedule's ProfilerStep annotation (its
    # device span is the whole step)
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")
            and not e.key.startswith("ProfilerStep")]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    # the profiler slows the host, so the idle share is taken against
    # the unprofiled step time above
    print(f"{app} profiled step: wall {wall_ms:.3f} ms (profiler on), "
          f"device busy {busy_us / 1e3:.3f} ms, idle share vs the "
          f"unprofiled step {1 - busy_us / 1e3 / step_ms:.3f}, {launches} "
          f"device kernels", flush=True)
    ours = [e for e in rows if any(f"{k}<" in e.key for k in (
        "rho_kernel", "tadv_kernel", "rhs3d_kernel", "uv_solve_kernel",
        "uv_finish_kernel", "vdiff_kernel", "flux_omega_kernel",
        "prsgrd_kernel", "uvmix_kernel", "half_step", "bulk_kernel",
        "stagger_kernel", "kpp_kernel",
        "rot_div_geo_kernel", "tridiag_kernel", "blocked_kernel"))]
    ours_us = sum(e.self_device_time_total for e in ours)
    print(f"{app} the port's CUDA kernels: {ours_us / 1e3:.3f} ms device "
          f"time in {sum(e.count for e in ours)} launches", flush=True)
    for e in sorted(ours, key=lambda e: -e.self_device_time_total):
        print(f"  ours {e.self_device_time_total / 1e3:9.4f} ms "
              f"{e.count:6d}x  {e.key[:90]}", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}", flush=True)


# the full-width UPWELLING deck of the deck phase: every stream on, the
# history with the derived and diagnosed fields
DECK_FULL = ["--lm", "512", "--mm", "1024", "--n", "16", "--dtype",
             "float32", "--ntimes", "20"]
DECK_STREAMS = """
       NINFO == 5
        NHIS == 10
        NAVG == 10
        NRST == 20
        NSTA == 1
   LcycleRST == T
     SPOSNAM == {spos}
""" + "\n".join(f"Hout({code}) == T" for code in (
    "idFsur", "idUbar", "idVbar", "idUvel", "idVvel", "idWvel", "idOvel",
    "idDano", "idUsms", "idUbms", "idVvis")) + "\nHout(idTvar) == T T\n"
# four stations (FLAG 0: grid indices I, J) inside 514 x 1026
STATIONS = """
    NSTATION ==  4
Sout(idFsur) == T
Sout(idUvel) == T
Sout(idTvar) == T
POS =  GRID  FLAG      X-POS       Y-POS     COMMENT
        1    0       10.0        20.0
        1    0      256.0       100.0
        1    0      256.0       512.0
        1    0      500.0      1000.0
"""
DECK_RECORDS = {"roms_his.nc": 2, "roms_avg.nc": 2, "roms_rst.nc": 1,
                "roms_sta.nc": 20}


def deck_text(app, cfg, ntimes, streams=""):
    """A reference-format roms.in deck (read_phypar.F keywords) carrying
    cfg's runtime keywords, as a user's deck for the app would."""
    v, e, m, bc = cfg.vert, cfg.eos, cfg.mixing, cfg.bc
    kind = {"periodic": "Per", "closed": "Clo"}

    def lbc(side):
        return " ".join(kind[getattr(side, edge)]
                        for edge in ("west", "south", "east", "north"))
    lines = [
        f"TITLE = {app} through the port's deck driver",
        f"MyAppCPP = {app.upper()}",
        f"Lm == {cfg.Lm}", f"Mm == {cfg.Mm}", f"N == {cfg.N}",
        f"NTIMES == {ntimes}", f"DT == {cfg.dt!r}",
        f"NDTFAST == {cfg.ndtfast}", f"Vtransform == {v.Vtransform}",
        f"Vstretching == {v.Vstretching}", f"THETA_S == {v.theta_s!r}",
        f"THETA_B == {v.theta_b!r}", f"TCLINE == {v.Tcline!r}",
        f"RHO0 == {cfg.rho0!r}", f"R0 == {e.R0!r}", f"T0 == {e.T0!r}",
        f"S0 == {e.S0!r}", f"TCOEF == {e.Tcoef!r}",
        f"SCOEF == {e.Scoef!r}", f"GAMMA2 == {cfg.gamma2!r}",
        f"VISC2 == {m.visc2!r}",
        "TNU2 == " + " ".join(repr(x) for x in m.tnu2),
        f"AKV_BAK == {m.akv_bak!r}",
        "AKT_BAK == " + " ".join(repr(x) for x in m.akt_bak),
        "RDRG == " + repr(cfg.drag.rdrg if cfg.drag.kind == "linear"
                          else 0.0),
        f"RDRG2 == {cfg.drag.rdrg2!r}"]
    for name, side in (("isFsur", bc.zeta), ("isUbar", bc.ubar),
                       ("isVbar", bc.vbar), ("isUvel", bc.u),
                       ("isVvel", bc.v), ("isTvar", bc.t),
                       ("isMtke", bc.tke)):
        lines.append(f"LBC({name}) == {lbc(side)}")
    return "\n".join(lines) + "\n" + streams


def write_deck(directory, app, cfg, ntimes, streams=""):
    path = os.path.join(directory, f"roms_{app}.in")
    with open(path, "w") as fh:
        fh.write(deck_text(app, cfg, ntimes, streams))
    return path


def same_state(torch, a, b, label):
    """Every field of two States equal bit for bit, at the same dtype."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "mix" and x is not None:
            same_state(torch, x, y, label)
            continue
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"{label}: {f} differs")
        elif x != y:
            fail(f"{label}: {f} {x} != {y}")


def deck_phase(torch):
    """The deck driver `python -m roms_tpu_torch` on the card: (a) the
    full-width UPWELLING deck with HIS, AVG, RST, STA and NINFO, no plain
    version called, its ms/step beside phase 4's bare step and the
    seconds per HIS record; (b) restart bit for bit, from the full-width
    run's RST record and over 3 + 3 float64 steps at 48 x 64 x 16; (c)
    the BENCHMARK deck and each new app's deck at its published size as
    subprocesses."""
    import tempfile

    import numpy as np
    from scipy.io import netcdf_file

    from roms_tpu_torch import __main__ as driver
    from roms_tpu_torch.functionals import upwelling as up
    from roms_tpu_torch.io.rst_netcdf import read_restart
    from roms_tpu_torch.ops import _lib
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spos = os.path.join(tmp, "stations.in")
        with open(spos, "w") as fh:
            fh.write(STATIONS)
        deck = write_deck(tmp, "upwelling", up.make_config(), 20,
                          DECK_STREAMS.format(spos=spos))
        _lib.reset_launches()
        run, plain_calls = plain_calls_during(lambda: driver.run(
            [deck, "--outdir", tmp, "--device", DEVICE] + DECK_FULL))
        counts = {k: n for k, n in _lib.launches.items() if n}
        if run.code != 0:
            fail(f"deck run exited {run.code}")
        if plain_calls:
            fail(f"deck run: plain versions ran on the card: {plain_calls}")
        for name in APPS["upwelling"]["entries"]:
            if counts.get(name, 0) < run.ntimes:
                fail(f"deck run: {name} launched {counts.get(name, 0)} "
                     f"times in {run.ntimes} steps")
        print(f"deck run launches in {run.ntimes} steps (output "
              f"included): {counts}; plain-version calls: 0", flush=True)
        for fname, nrec in DECK_RECORDS.items():
            f = netcdf_file(os.path.join(tmp, fname), "r", mmap=False)
            got = f.variables["ocean_time"].shape[0]
            if got != nrec:
                fail(f"deck run: {fname} has {got} records, expected "
                     f"{nrec}")
            for name, var in f.variables.items():
                if not np.isfinite(var.data).all():
                    fail(f"deck run: {fname} {name} not finite")
            print(f"deck run {fname}: {got} records, variables "
                  f"{sorted(f.variables)}", flush=True)
            f.close()
        ms_deck = 1e3 * run.seconds / run.ntimes
        cfg = run.model.cfg
        print(f"deck driver UPWELLING {cfg.Mm + 2}x{cfg.Lm + 2}x{cfg.N} "
              f"{cfg.dtype}: {ms_deck:.3f} "
              f"ms/step with every stream on (host wall, {run.ntimes} "
              f"steps), bare Model.run {BARE_MS['upwelling']:.3f} ms/step "
              f"(phase 4, CUDA events) [{CARD}]", flush=True)
        output_costs(torch, run, tmp)

        # (b) restart bit for bit
        r = read_restart(os.path.join(tmp, "roms_rst.nc"), run.model.cfg,
                         run.model.grid, template=run.state)
        same_state(torch, run.state, r, "full-width RST record")
        print("restart: the full-width float32 RST record equals the final "
              "state bit for bit", flush=True)
        restart_check(torch, tmp)
        del run, r
        torch.cuda.empty_cache()

        # (c) the decks as users run them
        deck_subprocesses(tmp)
    print(f"deck phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def output_costs(torch, run, tmp):
    """Seconds of each output event of the deck run at its size, timed
    alone on a copy of the final state (so that nothing is cached) between
    two synchronizations: a HIS record (three times), an AVG step and
    record, an RST record, a station sample and a NINFO line."""
    from roms_tpu_torch.core.diag import diag
    from roms_tpu_torch.io.netcdf import AverageAccumulator, HistoryWriter
    from roms_tpu_torch.io.rst_netcdf import RestartWriter
    from roms_tpu_torch.io.sta_netcdf import StationWriter
    cfg, grid, om = run.model.cfg, run.model.grid, run.output

    def timed(fn):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    his = HistoryWriter(os.path.join(tmp, "his_timing.nc"), cfg, grid,
                        fields=om.his.fields, model=run.model)
    secs = [timed(lambda: his.write(run.state._replace()))
            for _ in range(3)]
    his.close()
    avg = HistoryWriter(os.path.join(tmp, "avg_timing.nc"), cfg, grid,
                        fields=om.avg_writer.fields, model=run.model)
    acc = AverageAccumulator(cfg, avg.fields)
    t_acc = timed(lambda: acc.accumulate(avg._extract, run.state._replace()))

    def avg_record():
        mean = acc.mean()
        for key in avg.fields:
            avg.write_field(0, key, mean[key])
        avg.f.flush()
    t_avg = timed(avg_record)
    avg.close()
    rst = RestartWriter(os.path.join(tmp, "rst_timing.nc"), cfg, grid)
    t_rst = timed(lambda: rst.write(run.state))
    rst.close()
    sta = StationWriter(os.path.join(tmp, "sta_timing.nc"), cfg,
                        list(zip(om.sta.rec.jj, om.sta.rec.ii)),
                        fields=om.sta.rec.fields)
    t_sta = timed(lambda: sta.write(run.state))
    sta.close()
    t_info = timed(lambda: float(diag(cfg, grid, run.state).avgke))
    print(f"output event costs {cfg.Mm + 2}x{cfg.Lm + 2}x{cfg.N} "
          f"{cfg.dtype} [{CARD}]: HIS record ({len(his.fields)} fields "
          f"{list(his.fields)}) {secs[0]:.3f} / {secs[1]:.3f} / "
          f"{secs[2]:.3f} s; AVG accumulate {t_acc:.4f} s, AVG record "
          f"({len(avg.fields)} fields) {t_avg:.3f} s; RST record "
          f"{t_rst:.3f} s; station sample {t_sta:.4f} s; NINFO line "
          f"{t_info:.4f} s", flush=True)


def restart_check(torch, tmp):
    """UPWELLING at 48 x 64 x 16 float64: 3 steps, RST, read_restart, 3
    more equal 6 steps bit for bit."""
    from roms_tpu_torch.core.stepping import Model
    from roms_tpu_torch.functionals import upwelling as up
    from roms_tpu_torch.io.rst_netcdf import RestartWriter, read_restart
    cfg = up.make_config(Lm=48, Mm=64, N=16, dtype="float64")
    grid = up.make_grid(cfg, device=DEVICE)
    model = Model(cfg, grid, up.make_forcing_fn(cfg, grid),
                  vmix_fn=up.make_vmix_fn(cfg))
    s3 = model.run(up.make_initial(cfg, grid), 3)
    path = os.path.join(tmp, "restart_check.nc")
    w = RestartWriter(path, cfg, grid)
    w.write(s3)
    w.close()
    r3 = read_restart(path, cfg, grid)
    same_state(torch, model.run(s3, 3), model.run(r3, 3),
               "restart 3 + 3 steps")
    print("restart: 3 + 3 steps through read_restart equal 6 steps bit for "
          f"bit (UPWELLING {cfg.Mm + 2}x{cfg.Lm + 2}x{cfg.N} float64)",
          flush=True)


def deck_subprocesses(tmp):
    """`python -m roms_tpu_torch DECK` once on the BENCHMARK deck at its
    parity size and once on each new app's deck at its published size,
    3 steps each, all started together; each must exit 0."""
    from roms_tpu_torch.functionals import benchmark as bm
    from roms_tpu_torch.functionals import idealized as ia
    root = os.path.dirname(os.path.abspath(__file__))
    cases = [("benchmark", bm.make_config(Lm=64, Mm=32, N=16, dt=150.0,
                                          full_physics=True),
              ["--lm", "64", "--mm", "32", "--n", "16"])]
    cases += [(app, getattr(ia, f"{app}_config")(), [])
              for app in IDEALIZED]
    procs = []
    try:
        for app, cfg, extra in cases:
            out = os.path.join(tmp, app)
            os.makedirs(out)
            deck = write_deck(out, app, cfg, 3, "NHIS == 3\nNINFO == 1\n")
            procs.append((app, cfg, subprocess.Popen(
                [sys.executable, "-m", "roms_tpu_torch", deck, "--outdir",
                 out, "--device", DEVICE] + extra, cwd=root,
                env=dict(os.environ, PYTHONPATH=root),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for app, cfg, proc in procs:
            text, _ = proc.communicate(timeout=600)
            tail = " | ".join(text.strip().splitlines()[-2:])
            print(f"python -m roms_tpu_torch {app} deck "
                  f"({cfg.Lm}x{cfg.Mm}x{cfg.N}, 3 steps): exit "
                  f"{proc.returncode}: {tail}", flush=True)
            if proc.returncode != 0:
                fail(f"{app} deck: exit {proc.returncode}\n{text[-3000:]}")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(main())
