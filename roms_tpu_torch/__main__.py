"""Standalone driver: ``python -m roms_tpu_torch roms_upwelling.in``
(port of roms_tpu/__main__.py).

The reference's user experience is `oceanM < roms.in`: the master
program (Master/roms.h:1-140) reads the deck, builds the application
selected at compile time, time-steps NTIMES baroclinic steps and writes
the output streams.  This module is that program for the port: the
deck's MyAppCPP keyword selects the analytical application (longest
key first, so LAB_CANYON never runs as CANYON), the app header's
compile-time physics is merged as roms_tpu merges it, every runtime
keyword configures the model, and io/output.py's OutputManager writes
HIS/QCK/AVG/RST/STA and the NINFO table as the deck asks.

Usage:
  python -m roms_tpu_torch roms_upwelling.in [--ntimes N] [--outdir DIR]
      [--lm L --mm M --n K] [--dtype d] [--device cuda|cpu]

`--device` defaults to `cuda` and raises without a card; `cpu` runs the
plain PyTorch path and is meant for tests.  Every application, option or
input file the port does not run yet raises NotImplementedError naming
the ROADMAP Queue 1 item that brings it.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
from typing import NamedTuple

# applications of roms_tpu's driver that the port cannot run yet, with
# the ROADMAP Queue 1 item that brings each
_UNPORTED = {
    "KELVIN": "open boundaries (ROADMAP Queue 1 item 6)",
    "SOLITON": "the 2D-only engine with C4 momentum advection (ROADMAP "
               "Queue 1 item 7)",
    "OVERFLOW": "isopycnal tracer mixing (ROADMAP Queue 1 item 7)",
    "ESTUARY_TEST": "open boundaries (ROADMAP Queue 1 item 6)",
    "RIVERPLUME1": "open boundaries and point sources (ROADMAP Queue 1 "
                   "item 6)",
    "RIVERPLUME2": "open boundaries and point sources (ROADMAP Queue 1 "
                   "item 6)",
    "SED_TOY": "sediment (ROADMAP Queue 1 item 8)",
    "BL_TEST": "open boundaries (ROADMAP Queue 1 item 6)",
    "FLT_TEST": "BODYFORCE (ROADMAP Queue 1 item 7) and floats (ROADMAP "
                "Queue 1 item 8)",
    "SHOREFACE": "open boundaries (ROADMAP Queue 1 item 6)",
    "CHANNEL_NECK": "geopotential momentum mixing (ROADMAP Queue 1 "
                    "item 7)",
    "BIO_TOY": "biology (ROADMAP Queue 1 item 8)",
    "WEDDELL": "open boundaries (ROADMAP Queue 1 item 6)",
    "COUPLING_TEST": "coupling (ROADMAP Queue 1 item 8)",
    "LAKE_JERSEY": "the bottom boundary layer (ROADMAP Queue 1 item 8)",
    "TEST_HEAD": "open boundaries (ROADMAP Queue 1 item 6)",
    "TEST_CHAN": "open boundaries (ROADMAP Queue 1 item 6)",
    "SED_TEST1": "open boundaries (ROADMAP Queue 1 item 6)",
    "DOGBONE": "nesting (ROADMAP Queue 1 item 11)",
    "DAMEE_4": "the NetCDF grid and forcing readers (ROADMAP Queue 1 "
               "item 6)",
    "WC13": "the NetCDF grid and forcing readers (ROADMAP Queue 1 item 6)",
}

# input-file keywords whose readers are still to port: a deck that names
# an existing file under one of them is refused (an absent file falls
# back to the analytical functional, as in roms_tpu's driver)
_FILE_KEYWORDS = {
    "GRDNAME": "ROADMAP Queue 1 item 6", "BRYNAME": "ROADMAP Queue 1 item 6",
    "CLMNAME": "ROADMAP Queue 1 item 6", "FRCNAME": "ROADMAP Queue 1 item 6",
    "TIDENAME": "ROADMAP Queue 1 item 6", "BPARNAM": "ROADMAP Queue 1 item 8",
    "SPARNAM": "ROADMAP Queue 1 item 8", "IPARNAM": "ROADMAP Queue 1 item 8",
}

# the ported apps whose header physics (mixing closure, rotated
# diffusion, drag law, EOS, LBC set, wet/dry) roms_tpu's driver merges
# over the deck's; roms_tpu's other header apps join as they are ported
_HEADER_APPS = ("CANYON", "LAKE_SIGNELL", "WINDBASIN", "LMD_TEST",
                "MIXED_LAYER", "CHANNEL")


def _app_module(name: str):
    """(make_config, make_grid, make_initial, make_forcing, make_vmix) of
    the deck's MyAppCPP, matched longest key first (e.g. "BENCHMARK3"
    runs BENCHMARK); None for a custom (file-based) application."""
    from .functionals import benchmark, idealized as ia, upwelling
    name = (name or "UPWELLING").strip().upper()
    table = {
        "UPWELLING": (upwelling.make_config, upwelling.make_grid,
                      upwelling.make_initial, upwelling.make_forcing_fn,
                      upwelling.make_vmix_fn),
        "BENCHMARK": (benchmark.make_config, benchmark.make_grid,
                      benchmark.make_initial,
                      benchmark.make_bulk_forcing_fn, None),
        "SEAMOUNT": (ia.seamount_config, ia.seamount_grid,
                     ia.seamount_initial, ia.zero_forcing, None),
        "GRAV_ADJ": (ia.grav_adj_config, ia.grav_adj_grid,
                     ia.grav_adj_initial, ia.zero_forcing, None),
        "BASIN": (ia.basin_config, ia.basin_grid, ia.basin_initial,
                  ia.basin_forcing_fn, None),
        "DOUBLE_GYRE": (ia.double_gyre_config, ia.double_gyre_grid,
                        ia.double_gyre_initial, ia.double_gyre_forcing_fn,
                        None),
        "CANYON": (ia.canyon_config, ia.canyon_grid, ia.canyon_initial,
                   ia.zero_forcing, None),
        "WINDBASIN": (ia.windbasin_config, ia.windbasin_grid,
                      ia.windbasin_initial, ia.windbasin_forcing_fn, None),
        "CHANNEL": (ia.channel_config, ia.channel_grid, ia.channel_initial,
                    ia.channel_forcing_fn, None),
        "LAKE_SIGNELL": (ia.lake_signell_config, ia.lake_signell_grid,
                         ia.lake_signell_initial, ia.lake_signell_forcing_fn,
                         None),
        "LMD_TEST": (ia.lmd_test_config, ia.lmd_test_grid,
                     ia.lmd_test_initial, ia.lmd_test_forcing_fn, None),
        "MIXED_LAYER": (ia.mixed_layer_config, ia.mixed_layer_grid,
                        ia.mixed_layer_initial, ia.mixed_layer_forcing_fn,
                        None),
        "LAB_CANYON": (ia.lab_canyon_config, ia.lab_canyon_grid,
                       ia.lab_canyon_initial, ia.zero_forcing, None),
    }
    keys = set(table) | set(_UNPORTED)
    for key in sorted(keys, key=len, reverse=True):
        if key in name:
            if key in _UNPORTED:
                raise NotImplementedError(
                    f"MyAppCPP '{name}' ({key}) needs {_UNPORTED[key]}")
            return table[key]
    return None


class DeckRun(NamedTuple):
    code: int          # the exit code main returns
    state: object      # the final State
    model: object      # the Model that stepped it
    output: object     # the (closed) OutputManager
    ntimes: int        # steps taken
    seconds: float     # wall time of the stepping, output included


def _parser():
    p = argparse.ArgumentParser(prog="python -m roms_tpu_torch")
    p.add_argument("deck", help="reference-format roms_*.in input deck")
    p.add_argument("--ntimes", type=int, default=0,
                   help="override the deck's NTIMES")
    p.add_argument("--outdir", default=".")
    p.add_argument("--lm", type=int, default=0, help="override Lm")
    p.add_argument("--mm", type=int, default=0, help="override Mm")
    p.add_argument("--n", type=int, default=0, help="override N")
    p.add_argument("--dtype", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or "
                        "cpu (the plain PyTorch path, for tests)")
    p.add_argument("--mesh", default="",
                   help="device mesh of the multi-GPU engine")
    p.add_argument("--sharded-out", default="",
                   help="per-shard history output of the multi-GPU engine")
    return p


def run(argv=None) -> DeckRun:
    """Read the deck, build the model and step it with its output
    streams; the work of `main`."""
    args = _parser().parse_args(argv)
    from .device import resolve_device
    device = resolve_device(args.device)
    if args.mesh or args.sharded_out:
        raise NotImplementedError(
            "--mesh / --sharded-out: the multi-GPU engine is ROADMAP "
            "Queue 1 item 12")

    from .core import stepping
    from .io.output import OutputManager
    from .io.roms_in import parse_roms_in, to_config

    os.makedirs(args.outdir, exist_ok=True)
    params = parse_roms_in(args.deck)
    title = params.get("TITLE", "")
    if isinstance(title, list):
        title = " ".join(str(x) for x in title)
    app = params.get("MyAppCPP", "UPWELLING")
    print(f"roms_tpu_torch: {title}  [{app}] on {device}")

    ngrids = params.get("Ngrids", 1)
    ngrids = ngrids[0] if isinstance(ngrids, list) else ngrids
    if int(ngrids or 1) > 1:
        raise NotImplementedError(
            f"Ngrids = {ngrids}: multi-grid decks need nesting (ROADMAP "
            "Queue 1 item 11)")

    def deck_files(key):
        v = params.get(key)
        vs = v if isinstance(v, list) else [v]
        return [s for s in vs if isinstance(s, str) and os.path.isfile(s)]

    for key, item in _FILE_KEYWORDS.items():
        if deck_files(key):
            raise NotImplementedError(
                f"{key} {deck_files(key)[0]}: its reader is {item}")

    mod = _app_module(app)
    if mod is None:
        raise SystemExit(
            f"MyAppCPP '{app}' has no analytical functional here and the "
            "deck names no existing GRDNAME grid file")
    mk_cfg, mk_grid, mk_init, mk_forc, mk_vmix = mod
    over = {}
    if args.lm:
        over["Lm"] = args.lm
    if args.mm:
        over["Mm"] = args.mm
    if args.dtype:
        over["dtype"] = args.dtype
    cfg = to_config(params, **over)
    if args.n:
        cfg = cfg.replace(vert=dataclasses.replace(cfg.vert, N=args.n))
    if "BENCHMARK" in app.upper():
        # the app HEADER's compile-time physics (benchmark.h: LMD-KPP +
        # SOLAR_SOURCE + quadratic drag + nonlinear EOS); the runtime
        # keywords keep dims, steps and cadences
        from .functionals import benchmark as bm
        hdr = bm.make_config(full_physics=True)
        cfg = cfg.replace(mixing=hdr.mixing, drag=hdr.drag, eos=hdr.eos)
    elif any(k in app.upper() for k in _HEADER_APPS):
        hdr = mk_cfg()
        cfg = cfg.replace(mixing=hdr.mixing, drag=hdr.drag, eos=hdr.eos,
                          bc=hdr.bc, uv_cor=hdr.uv_cor, wetdry=hdr.wetdry,
                          Dcrit=hdr.Dcrit)
    if cfg.nudg.luv_sponge or any(cfg.nudg.ltracer_sponge):
        raise NotImplementedError(
            "LuvSponge / LtracerSponge: sponge layers are ROADMAP Queue 1 "
            "item 6")

    grid = mk_grid(cfg, device=device)
    ini = deck_files("ININAME")
    if ini:
        from .io.state_nc import read_state_netcdf
        nrrec = int(params.get("NRREC", 0) or 0)
        state = read_state_netcdf(ini[0], cfg, grid,
                                  rec=nrrec - 1 if nrrec > 0 else -1)
        print(f"initial state from file: {ini[0]}")
    else:
        state = mk_init(cfg, grid)
    model = stepping.Model(cfg, grid, forcing_fn=mk_forc(cfg, grid),
                           vmix_fn=mk_vmix(cfg) if mk_vmix else None)
    om = OutputManager(cfg, grid, params, outdir=args.outdir,
                       initial_state=state, model=model)
    if om.unsupported:
        print("unsupported output ids (skipped):",
              ", ".join(sorted(set(om.unsupported))))

    ntimes = args.ntimes or int(params.get("NTIMES", 0))
    print(f"stepping {ntimes} x dt={cfg.dt}s (ndtfast={cfg.ndtfast}) on "
          f"{cfg.Lm}x{cfg.Mm}x{cfg.N} {cfg.dtype}")
    t0 = time.perf_counter()
    # Chunked advance: when no stream needs every step (AVG and DIA
    # accumulate per step), run whole between-output windows through
    # Model.run; tensors reach the host only at output events.
    if om.avg is None and not om.wants_diag and not om.wants_diag_uv:
        cadences = om.cadences()
        chunk = math.gcd(*cadences) if cadences else ntimes
    else:
        chunk = 1
    done = 0
    if chunk > 1 and ntimes >= chunk:
        print(f"advancing in chunks of {chunk} steps")
        while done < ntimes:
            n = min(chunk, ntimes - done)
            state = model.run(state, n)
            done += n
            om.step(state)
    for _ in range(ntimes - done):
        if om.wants_diag_uv:
            state, _dia_uv = model.step_diag_uv(state)
        elif om.wants_diag:
            state, _dia = model.step_diag(state)
        else:
            state = model.step(state)
        om.step(state)
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    om.close()
    import torch
    if not bool(torch.isfinite(state.zeta).all()):
        print("BLOW-UP detected (non-finite zeta)", file=sys.stderr)
        return DeckRun(1, state, model, om, ntimes, seconds)
    pts = cfg.Lm * cfg.Mm * cfg.N * max(ntimes, 1)
    print(f"done: {seconds:.2f}s wall, {1e3 * seconds / max(ntimes, 1):.3f} "
          f"ms/step ({pts / max(seconds, 1e-9):.3e} gridpoint-steps/s)")
    return DeckRun(0, state, model, om, ntimes, seconds)


def main(argv=None) -> int:
    return run(argv).code


if __name__ == "__main__":
    sys.exit(main())
