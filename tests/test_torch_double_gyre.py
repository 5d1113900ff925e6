"""Slice parity: the DOUBLE_GYRE baroclinic step of roms_tpu_torch
(plain PyTorch path on the CPU) against roms_tpu's Model.run, float64,
from the same initial state.

The bound is the cross-engine gate of tests/test_correctness_gates.py:
1e-10 relative plus 5e-14 absolute, over whole arrays (ring rows
included) after each of the compared step counts.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from roms_tpu.core import stepping
from roms_tpu.functionals import idealized as ia
from roms_tpu_torch.config import LBC, RADIATION, BoundaryConfig
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.functionals import idealized as tia

from torch_port_util import port, reference_run, t2n

FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    cfg = ia.double_gyre_config(Lm=16, Mm=32, N=6, dtype="float64")
    grid = ia.double_gyre_grid(cfg)
    s0 = ia.double_gyre_initial(cfg, grid)
    ref = reference_run(stepping.Model(
        cfg, grid, ia.double_gyre_forcing_fn(cfg, grid)), s0, 4)
    tcfg, tgrid, ts0 = port(cfg, grid, s0)
    model = tstepping.Model(tcfg, tgrid,
                            tia.double_gyre_forcing_fn(tcfg, tgrid))
    steps = [ts0]
    for _ in range(4):
        steps.append(model.step(steps[-1]))
    return ref, steps


@pytest.mark.parametrize("field", FIELDS)
def test_trajectory_matches_roms_tpu(runs, field):
    ref, steps = runs
    x = np.asarray(getattr(ref, field))
    y = t2n(getattr(steps[-1], field))
    assert np.isfinite(y).all()
    scale = np.abs(x).max() + 1e-30
    assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
        (field, np.abs(y - x).max(), scale)


def test_interior_volume_conserved(runs):
    """Interior mean of zeta (rings excluded) stays at its initial value
    to float64 roundoff over every step."""
    _, steps = runs
    vols = [float(s.zeta[1:-1, 1:-1].mean()) for s in steps]
    assert max(abs(v - vols[0]) for v in vols) < 1e-15
    assert steps[-1].iic == 4


def test_port_imports_neither_jax_nor_roms_tpu():
    code = (
        "import sys, roms_tpu_torch\n"
        "import roms_tpu_torch.core.stepping, roms_tpu_torch.convert\n"
        "import roms_tpu_torch.functionals.idealized\n"
        "import roms_tpu_torch.ops._lib, roms_tpu_torch.ops.rho\n"
        "import roms_tpu_torch.ops.tadv, roms_tpu_torch.ops.rhs3d\n"
        "import roms_tpu_torch.ops.uv, roms_tpu_torch.ops.vdiff\n"
        "import roms_tpu_torch.ops.flux, roms_tpu_torch.ops.prsgrd\n"
        "import roms_tpu_torch.ops.uvmix, roms_tpu_torch.ops.step2d\n"
        "import roms_tpu_torch.functionals.upwelling\n"
        "import roms_tpu_torch.__main__, roms_tpu_torch.core.diag\n"
        "import roms_tpu_torch.io.output, roms_tpu_torch.io.state_nc\n"
        "import roms_tpu_torch.io.rst_netcdf, roms_tpu_torch.io.sta_netcdf\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'roms_tpu' or m.startswith('roms_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parent.parent)


UNPORTED = sorted(tstepping._LATER) + [
    "vmix=gls", "vmix=my25", "prsgrd=fv", "step2d=fb",
    "step_diag", "step_diag_uv", "mix_iso_ts=1", "mix_geo_uv=1",
    "smagorinsky=1", "omega_implicit=1", "wetdry=1", "bc=radiation"]
# refusals that name the ROADMAP item that ports them
ROADMAP_ITEM = {"obc_fn": "ROADMAP Queue 1 item 6",
                "clm_fn": "ROADMAP Queue 1 item 6",
                "sources": "ROADMAP Queue 1 item 6",
                "eq_tide_fn": "ROADMAP Queue 1 item 6",
                "pair_fn": "ROADMAP Queue 1 item 6",
                "bio_fn": "ROADMAP Queue 1 item 8",
                "sed_fn": "ROADMAP Queue 1 item 8",
                "bbl_fn": "ROADMAP Queue 1 item 8",
                "ice_fn": "ROADMAP Queue 1 item 8",
                "wec_fn": "ROADMAP Queue 1 item 8",
                "flux_corr_fn": "ROADMAP Queue 1 item 8",
                "step_diag": "ROADMAP Queue 1 item 10",
                "step_diag_uv": "ROADMAP Queue 1 item 10",
                "prsgrd=fv": "ROADMAP Queue 1 item 7",
                "step2d=fb": "ROADMAP Queue 1 item 7",
                "mix_iso_ts=1": "ROADMAP Queue 1 item 7",
                "mix_geo_uv=1": "ROADMAP Queue 1 item 7",
                "smagorinsky=1": "ROADMAP Queue 1 item 7",
                "bc=radiation": "open boundary 'radiation' .*ROADMAP Queue 1 "
                                "item 6",
                "omega_implicit=1": "OMEGA_IMPLICIT: ROADMAP Queue 1 item 7",
                "wetdry=1": "WET_DRY: ROADMAP Queue 1 item 7"}


@pytest.mark.parametrize("what", UNPORTED)
def test_unported_hooks_raise(what):
    """Every hook and branch DOUBLE_GYRE does not take raises
    NotImplementedError rather than being skipped."""
    cfg = tia.double_gyre_config(Lm=6, Mm=6, N=4)
    grid = tia.double_gyre_grid(cfg, device="cpu")
    forcing_fn = tia.double_gyre_forcing_fn(cfg, grid)
    # GLS and MY2.5 run since the GLS slice: what they still refuse is
    # the open TKE boundary, raised by the closures' boundary hook
    tke_bc = what in ("vmix=gls", "vmix=my25")
    with pytest.raises(NotImplementedError, match="open boundary 'radiation'"
                       if tke_bc else ROADMAP_ITEM.get(what)) as exc:
        if what.startswith("step_diag"):
            model = tstepping.Model(cfg, grid, forcing_fn)
            getattr(model, what)(tia.double_gyre_initial(cfg, grid))
        elif "=" in what:
            field, val = what.split("=")
            if tke_bc:
                # open TKE boundaries (tkebc_im.F radiation) are still
                # to come
                cfg = cfg.replace(
                    mixing=dataclasses.replace(cfg.mixing, vmix=val),
                    bc=dataclasses.replace(cfg.bc, tke=LBC.same(RADIATION)))
                tstepping.Model(cfg, grid, forcing_fn).step(
                    tia.double_gyre_initial(cfg, grid))
            elif field == "bc":
                cfg = cfg.replace(bc=BoundaryConfig.uniform(LBC.same(val)))
                tstepping.Model(cfg, grid, forcing_fn).step(
                    tia.double_gyre_initial(cfg, grid))
            elif field in ("omega_implicit", "wetdry"):
                cfg = cfg.replace(**{field: True})
            elif hasattr(cfg.mixing, field):
                cfg = cfg.replace(mixing=dataclasses.replace(
                    cfg.mixing, vmix="lmd", **{field: bool(int(val))}))
            else:
                cfg = cfg.replace(**{field: val})
            tstepping.Model(cfg, grid, forcing_fn)
        else:
            tstepping.Model(cfg, grid, forcing_fn, **{what: object()})
    if tke_bc:
        assert "_bc_w" in [entry.name for entry in exc.traceback]


def test_cuda_entry_points_refuse_a_missing_card(monkeypatch):
    """device='cuda' (the default) raises when CUDA is absent, instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tia.double_gyre_config(Lm=8, Mm=8, N=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tia.double_gyre_grid(cfg)
