"""The seven kernel entry points of roms_tpu_torch: each plain PyTorch
version (what the wrapper runs on CPU tensors) against roms_tpu, float64,
inputs made from a numpy seed on a small DOUBLE_GYRE grid.

roms_tpu runs as its own Pallas tests run it on the CPU: the Pallas
kernel in interpret mode (env set by monkeypatch) and, where it
documents them, its jnp counterparts.  Tolerance 1e-12 relative; over
the interior rows for tadv/rhs3d (their ring rows are dead data that
the kernels zero), over whole arrays for rho/uv/vdiff.

The CUDA kernels themselves need a card: tests/test_torch_cuda.py.
Also here: the gate tests proving the port covers every Pallas kernel
roms_tpu's float32 step runs on one TPU, and that each kernel module's
`covers(cfg)` fires exactly where roms_tpu's gate does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.core import rhs3d as jrhs3d
from roms_tpu.core.omega import omega
from roms_tpu.functionals import idealized as ia
from roms_tpu.grid.depth import set_depth, set_massflux
from roms_tpu.ops import (pallas_rho, pallas_rhs3d, pallas_tadv, pallas_uv,
                          pallas_vdiff)
from roms_tpu_torch.ops import rho as trho, rhs3d as trhs3d, tadv as ttadv
from roms_tpu_torch.ops import uv as tuv, vdiff as tvdiff

from torch_port_util import port, rel_err
from torch_port_util import xla_fast_compiles  # noqa: F401

TOL = 1e-12
IICS = (0, 1, 5)


def _cffs(cfg, iic):
    Gamma = 1.0 / 6.0
    if iic == 0:
        return 0.5 * cfg.dt, 1.0, 0.0
    return (1.0 - Gamma) * cfg.dt, 0.5 + Gamma, 0.5 - Gamma


def _cffab(cfg, iic):
    dt = cfg.dt
    return (0.25 * dt, 0.25 * dt * 1.5, 0.25 * dt * 23.0 / 12.0)[min(iic, 2)]


@pytest.fixture(scope="module")
def case():
    """DOUBLE_GYRE at Lm=12, Mm=20, N=6 with seeded fields, as numpy
    arrays plus the config/grid of both packages."""
    torch.set_num_threads(1)
    cfg = ia.double_gyre_config(Lm=12, Mm=20, N=6, dtype="float64")
    grid = ia.double_gyre_grid(cfg)
    s = ia.double_gyre_initial(cfg, grid)
    rng = np.random.default_rng(2024)
    N, (Mj, Li), NT = cfg.N, cfg.shape2d, cfg.NT
    z_r, z_w, Hz = set_depth(grid, jnp.asarray(
        0.05 * rng.standard_normal((Mj, Li))))
    u = jnp.asarray(0.1 * rng.standard_normal((N, Mj, Li))) * grid.umask
    v = jnp.asarray(0.1 * rng.standard_normal((N, Mj, Li))) * grid.vmask
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    W = omega(cfg, grid, Huon, Hvom, z_w)
    t = s.t + jnp.asarray(0.1 * rng.standard_normal((NT, N, Mj, Li)))
    arrays = dict(
        z_r=z_r, z_w=z_w, Hz=Hz, u=u, v=v, Huon=Huon, Hvom=Hvom, W=W, t=t,
        t_prev=t + jnp.asarray(0.01 * rng.standard_normal(t.shape)),
        ru=jnp.asarray(rng.standard_normal((N, Mj, Li))),
        rv=jnp.asarray(rng.standard_normal((N, Mj, Li))),
        Akv=jnp.asarray(1e-3 * np.abs(rng.standard_normal((N + 1, Mj, Li)))
                        + 1e-5),
        Akt=jnp.asarray(1e-3 * np.abs(rng.standard_normal(
            (cfg.NAT, N + 1, Mj, Li))) + 1e-6),
        avg=[jnp.asarray(0.01 * rng.standard_normal((Mj, Li)))
             * jnp.sum(Hz, axis=0) * m
             for m in (grid.on_u, grid.om_v, grid.on_u, grid.om_v)])
    tcfg, tgrid = port(cfg, grid)
    return cfg, grid, tcfg, tgrid, arrays


def _t(x):
    if isinstance(x, list):
        return [_t(y) for y in x]
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "jm95"])
def test_rho_eos_plain(case, linear):
    cfg, grid, tcfg, _, a = case
    if not linear:
        eos = cfg.eos.__class__(linear=False)
        cfg, tcfg = cfg.replace(eos=eos), tcfg.replace(eos=eos.__class__(
            linear=False))
    args = (a["t"], a["z_r"], a["Hz"], a["z_w"])
    ref = pallas_rho.rho_eos_pallas(cfg, *args, interpret=True)
    got = trho.rho_eos(tcfg, *_t(list(args)))
    for r, g in zip(ref, got):
        assert rel_err(r, g) < TOL


@pytest.mark.parametrize("iic", IICS)
def test_tadv_predictor_plain(case, monkeypatch, iic):
    monkeypatch.setenv("ROMS_TPU_PALLAS_TADV_INTERPRET", "1")
    cfg, grid, tcfg, tgrid, a = case
    args = [a[k] for k in ("t", "t_prev", "Huon", "Hvom", "W", "Hz")]
    sc = _cffs(cfg, iic)
    ref = pallas_tadv.predictor_pallas(cfg, grid, *args,
                                       *[jnp.asarray(x) for x in sc])
    got = ttadv.predictor(tcfg, tgrid, *_t(args), *sc)
    assert rel_err(ref, got, np.s_[..., 1:-1, :]) < TOL
    assert not got[..., 0, :].any() and not got[..., -1, :].any()


def test_tadv_corrector_plain(case, monkeypatch):
    monkeypatch.setenv("ROMS_TPU_PALLAS_TADV_INTERPRET", "1")
    cfg, grid, tcfg, tgrid, a = case
    t_part = a["Hz"][None] * a["t"]
    args = [a["t"], t_part] + [a[k] for k in ("Huon", "Hvom", "W", "Hz")]
    ref = pallas_tadv.corrector_pallas(cfg, grid, *args)
    got = ttadv.corrector(tcfg, tgrid, *_t(args))
    assert rel_err(ref, got, np.s_[..., 1:-1, :]) < TOL


def test_rhs3d_momentum_plain(case):
    cfg, grid, tcfg, tgrid, a = case
    args = [a[k] for k in ("u", "v", "Hz", "Huon", "Hvom", "W", "ru", "rv")]
    got = trhs3d.rhs3d_momentum(tcfg, tgrid, *_t(args))
    # every interior row against the jnp path (its ring rows hold
    # roll-wrap values; the kernel's are zero)
    ref = jrhs3d.coriolis(cfg, grid, a["u"], a["v"], a["Hz"])
    ru, rv = a["ru"] + ref[0], a["rv"] + ref[1]
    hu, hv = jrhs3d.hadv_uv(cfg, grid, a["u"], a["v"], a["Huon"],
                            a["Hvom"])
    ru, rv = ru + hu, rv + hv
    wu, wv = jrhs3d.vadv_uv(cfg, a["u"], a["v"], a["W"])
    ru, rv = ru + wu, rv + wv
    for r, g in zip((ru, rv), got):
        assert rel_err(r, g, np.s_[:, 1:-1, :]) < TOL
        assert not g[:, 0].any() and not g[:, -1].any()
    # the Pallas kernel over the interior its own tests compare
    pal = pallas_rhs3d.rhs3d_momentum_pallas(cfg, grid, *args,
                                             interpret=True)
    assert rel_err(pal[0], got[0], np.s_[:, 1:-1, 1:-1]) < TOL
    assert rel_err(pal[1], got[1], np.s_[:, 2:-1, 1:-1]) < TOL


@pytest.mark.parametrize("iic", IICS)
def test_uv_solve_plain(case, iic):
    cfg, grid, tcfg, tgrid, a = case
    Hz = a["Hz"]
    args = [a["u"] * Hz, a["v"] * Hz, 1e-2 * a["ru"], 1e-2 * a["rv"], Hz,
            a["Akv"]]
    ref = pallas_uv.uv_solve_pallas(cfg, grid, *args, _cffab(cfg, iic),
                                    a["avg"][0], a["avg"][1],
                                    interpret=True)
    got = tuv.uv_solve(tcfg, tgrid, *_t(args), _cffab(cfg, iic),
                       *_t(a["avg"][:2]))
    for r, g in zip(ref, got):
        assert rel_err(r, g) < TOL


def test_uv_finish_plain(case):
    cfg, grid, tcfg, tgrid, a = case
    args = [a[k] for k in ("u", "v", "Hz", "Huon", "Hvom")] + a["avg"]
    ref = pallas_uv.uv_finish_pallas(cfg, grid, *args, interpret=True)
    got = tuv.uv_finish(tcfg, tgrid, *_t(args))
    assert len(ref) == len(got) == 6
    for r, g in zip(ref, got):
        assert rel_err(r, g) < TOL


def test_spline_vdiff_plain(case):
    cfg, grid, tcfg, _, a = case
    pre = a["Hz"][None] * a["t"]
    ref = pallas_vdiff.spline_vdiff_pallas(
        cfg, [pre[i] for i in range(cfg.NT)], a["Hz"], a["Akt"],
        interpret=True)
    got = tvdiff.spline_vdiff(tcfg, *_t([pre, a["Hz"], a["Akt"]]))
    assert rel_err(ref, got) < TOL


# --------------------------------------------------------------------------
# gate test: which Pallas kernels roms_tpu's step runs on one TPU
# --------------------------------------------------------------------------

def _fired(cfg, bulk=False):
    """roms_tpu's kernels on one TPU; `bulk`: the forcing function takes
    the ocean surface state (make_bulk_forcing), where use_pallas_kpp
    sends the bulk fluxes through their kernel.  The tridiagonal kernel
    fires where the step solves a 3-D system (ops/tridiag.py:51-57): the
    GLS/MY2.5 closures, the jnp LMD route's spline shear (lmd.py:145)
    and OMEGA_IMPLICIT's upwind solves (step3d_uv.py:98)."""
    from roms_tpu.ops import (pallas_flux, pallas_hmix, pallas_kpp,
                              pallas_prep, pallas_prsgrd, pallas_step2d,
                              pallas_uvmix)
    from roms_tpu.ops.kernel_gate import dtype_supported, pallas_enabled
    m = cfg.mixing
    kpp_class = m.vmix == "lmd" and not m.bkpp and not m.ddmix
    use_prep = pallas_prep.use_pallas_prep(cfg) and kpp_class
    jnp_lmd = m.vmix == "lmd" and not use_prep and not (
        kpp_class and pallas_kpp.use_pallas_kpp(cfg))
    solve3d = m.vmix in ("gls", "my25") or jnp_lmd or cfg.omega_implicit
    gates = {
        "flux": pallas_flux.use_pallas_flux(cfg),
        "prep": use_prep,
        "rho": pallas_rho.use_pallas_rho(cfg) and not use_prep,
        "kpp": kpp_class and not use_prep
        and pallas_kpp.use_pallas_kpp(cfg),
        "bulk": bulk and pallas_kpp.use_pallas_kpp(cfg),
        "tadv": pallas_tadv.use_pallas_tadv(cfg, "predictor")
        or pallas_tadv.use_pallas_tadv(cfg, "corrector"),
        "prsgrd": cfg.prsgrd == "djs"
        and pallas_prsgrd.use_pallas_prsgrd(cfg),
        "rhs3d": jrhs3d._use_pallas_rhs3d(cfg),
        "uvmix": cfg.mixing.visc2 > 0.0
        and pallas_uvmix.use_pallas_uvmix(cfg),
        "hmix": m.mix_geo_ts and not m.mix_iso_ts
        and (any(m.tnu2) or any(m.tnu4)) and not cfg.bc.ns_periodic
        and pallas_hmix.use_pallas_hmix(cfg),
        "fast_loop_pallas_res": pallas_step2d.use_pallas_fastloop_res(
            cfg, cfg.shape2d),
        "fast_loop_pallas": pallas_step2d.use_pallas_step2d(cfg),
        "uv": pallas_uv.use_pallas_uv(cfg),
        "vdiff": cfg.mixing.splines_vdiff
        and pallas_vdiff.use_pallas_vdiff(cfg),
        "tridiag": solve3d and pallas_enabled()
        and dtype_supported(cfg.dtype) and cfg.N - 1 <= 128,
    }
    return {k for k, on in gates.items() if on}


def test_slice_covers_the_tpu_kernels_of_double_gyre(monkeypatch):
    for var in [v for v in os.environ if v.startswith("ROMS_TPU_")]:
        monkeypatch.delenv(var)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    dg = ia.double_gyre_config(Lm=512, Mm=1024, N=30, dt=240.0,
                               dtype="float32")
    assert _fired(dg) == {"rho", "tadv", "rhs3d", "uv", "vdiff"}
    # the same probe sees the nine kernels of the EW-periodic channel
    from roms_tpu.functionals import upwelling
    up = upwelling.make_config(dtype="float32")
    assert _fired(up) == {"flux", "rho", "tadv", "prsgrd", "rhs3d",
                          "uvmix", "fast_loop_pallas_res", "uv", "vdiff"}


def _port_fired(cfg, bulk=False, engine="resident"):
    """The port's kernel classes (each ops module's `covers`, the fast
    loop's engine switch, the step's LMD-KPP route, the closures'
    call-site gate on their solves), as the set of roms_tpu kernel names
    they stand for."""
    from roms_tpu_torch import convert
    from roms_tpu_torch.core.step2d import fast_loop_kernel
    from roms_tpu_torch.core.stepping import kpp_route
    from roms_tpu_torch.ops import (bulk as tbulk, flux, hmix as thmix,
                                    prsgrd, rho, rhs3d, step2d, tadv, uv,
                                    uvmix, vdiff)
    from torch_port_util import cfg_dict
    tcfg = convert.config_from_dict(cfg_dict(cfg))
    gates = {"flux": flux, "tadv": tadv, "prsgrd": prsgrd, "rhs3d": rhs3d,
             "uvmix": uvmix, "hmix": thmix, "uv": uv, "vdiff": vdiff}
    fired = {k for k, mod in gates.items() if mod.covers(tcfg)}
    fast = fast_loop_kernel(tcfg, engine)
    if fast is not None:
        fired.add({step2d.fast_loop_res: "fast_loop_pallas_res",
                   step2d.fast_loop_blocked: "fast_loop_pallas"}[fast])
    route = kpp_route(tcfg)
    if route == "prep":
        fired.add("prep")
    elif rho.covers(tcfg):
        fired.add("rho")
    if bulk and tbulk.covers(tcfg):
        fired.add("bulk")
    if (tcfg.mixing.vmix in ("gls", "my25") or route == "whole_array") \
            and _solve_reaches_kernel(tcfg, route):
        fired.add("tridiag")
    return fired


def _solve_reaches_kernel(tcfg, route):
    """Whether the solves of the N-1 interior interfaces reach kernel
    17's wrapper through their call-site gate (core/gls.py
    closure_solve; on the whole-array LMD route through core/lmd.py
    spline_ddz), observed on meta tensors with the wrapper replaced by a
    recorder."""
    from roms_tpu_torch.core import gls as tgls, lmd as tlmd
    from roms_tpu_torch.ops import tridiag
    seen = []
    solve = tridiag.tridiag_solve

    def spy(lower, diag, upper, rhs, use_kernels=True):
        seen.append(rhs.shape)
        return rhs
    tridiag.tridiag_solve = spy
    try:
        x = torch.empty((tcfg.N - 1,) + tcfg.shape2d, device="meta")
        if route == "whole_array":
            tlmd.spline_ddz(x, torch.empty((tcfg.N,) + tcfg.shape2d,
                                           device="meta"))
        else:
            tgls.closure_solve(x, x, x, x)
    finally:
        tridiag.tridiag_solve = solve
    return bool(seen)


def _gate_configs():
    """name -> (roms_tpu config, whether its forcing takes the ocean
    surface state)."""
    import dataclasses

    from roms_tpu.config import (CLAMPED, LBC, PERIODIC, BoundaryConfig)
    from roms_tpu.functionals import benchmark, upwelling
    up = upwelling.make_config(dtype="float32")
    bm3 = benchmark.make_config(Lm=2048, Mm=256, N=30, dtype="float32",
                                full_physics=True)

    def mixing(cfg, **kw):
        return cfg.replace(mixing=dataclasses.replace(cfg.mixing, **kw))

    up_gls = mixing(up, vmix="gls", gls_stab="kantha_clayson")

    cfgs = {
        "double_gyre": ia.double_gyre_config(Lm=512, Mm=1024, N=30,
                                             dt=240.0, dtype="float32"),
        "upwelling": up,
        "upwelling_full_width": upwelling.make_config(
            Lm=512, Mm=1024, N=16, dtype="float32"),
        "ns_periodic": up.replace(bc=BoundaryConfig.uniform(
            LBC.ns_periodic())),
        "open_ns_zeta": up.replace(bc=up.bc.__class__(
            **{**{f: getattr(up.bc, f) for f in ("ubar", "vbar", "u", "v",
                                                  "t", "tke", "volcons")},
               "zeta": LBC(west=PERIODIC, east=PERIODIC, south=CLAMPED,
                           north=CLAMPED)})),
        "omega_implicit": up.replace(omega_implicit=True),
        "visc2_zero": up.replace(mixing=up.mixing.__class__(
            **{**up.mixing.__dict__, "visc2": 0.0})),
        "wetdry": up.replace(wetdry=True),
        "upwelling_gls": up_gls,
        "upwelling_my25": mixing(up, vmix="my25"),
        "upwelling_gls_ns_periodic": up_gls.replace(
            bc=BoundaryConfig.uniform(LBC.ns_periodic())),
    }
    out = {k: (c, False) for k, c in cfgs.items()}
    out.update({
        "benchmark3_full_physics": (bm3, True),
        "benchmark3_light": (benchmark.make_config(
            Lm=2048, Mm=256, N=30, dtype="float32"), False),
        "benchmark3_bkpp": (mixing(bm3, bkpp=True), True),
        "benchmark3_ddmix": (mixing(bm3, ddmix=True), True),
        "benchmark3_ns_periodic": (bm3.replace(bc=BoundaryConfig.uniform(
            LBC.ns_periodic())), True),
        "benchmark3_constant_vmix": (mixing(bm3, vmix="constant"), True),
        "benchmark3_tnu_zero": (mixing(bm3, tnu2=(0.0, 0.0)), True),
    })
    # the analytical apps that need only ported physics, at their
    # published sizes: one case that loops over them
    out["analytical_apps"] = [
        (getattr(ia, f"{app}_config")(dtype="float32"), False)
        for app in APP_KERNELS]
    return out


# the kernels each analytical app's float32 step runs on one TPU
APP_KERNELS = {
    "basin": {"rho", "tadv", "rhs3d", "uv", "vdiff"},
    "seamount": {"rho", "tadv", "rhs3d", "uv", "vdiff"},
    "grav_adj": {"rho", "tadv", "rhs3d", "uv", "vdiff"},
    "windbasin": {"rho", "tadv", "rhs3d", "uv", "vdiff"},
    "canyon": {"flux", "rho", "tadv", "prsgrd", "rhs3d", "uvmix",
               "fast_loop_pallas_res", "uv", "vdiff", "hmix"},
    "channel": {"flux", "rho", "tadv", "prsgrd", "rhs3d", "uvmix",
                "fast_loop_pallas_res", "uv", "vdiff"},
    "lake_signell": {"rho", "tadv", "rhs3d", "uv", "vdiff", "tridiag"},
    "lmd_test": {"rho", "vdiff", "tridiag"},
    "mixed_layer": {"rho", "vdiff", "tridiag"},
    "lab_canyon": {"rho", "vdiff"},
}


BENCHMARK3_FULL = {"flux", "prep", "tadv", "prsgrd", "rhs3d", "uvmix",
                   "fast_loop_pallas_res", "uv", "vdiff", "hmix", "bulk"}
# roms_tpu reaches the tridiagonal kernel on this through a route the
# port refuses (OMEGA_IMPLICIT's upwind solves): the port's Model raises
# there, and has no such solve site
REFUSED_TRIDIAG_ROUTES = {"omega_implicit"}


@pytest.mark.parametrize("name", list(_gate_configs()))
def test_port_gates_match_roms_tpu(monkeypatch, name):
    """On every configuration the port's kernel classes fire exactly the
    kernels roms_tpu's float32 step runs on one TPU: the closed basin,
    the channel at the published and the full width (all nine), with
    the GLS and MY2.5 closures (ten, the tridiagonal solve added),
    BENCHMARK3 with the full physics (eleven), its light variant (ten)
    and with LMD_BKPP or LMD_DDMIX (twelve: the EOS and the spline solves
    of the whole-array LMD route), configurations just outside each
    class, and the ten analytical apps at their published sizes
    (APP_KERNELS)."""
    for var in [v for v in os.environ if v.startswith("ROMS_TPU_")]:
        monkeypatch.delenv(var)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    if name == "analytical_apps":
        for app, (cfg, bulk) in zip(APP_KERNELS, _gate_configs()[name]):
            fired = _fired(cfg, bulk)
            assert fired == APP_KERNELS[app], (app, fired)
            assert _port_fired(cfg, bulk) == fired, app
        return
    cfg, bulk = _gate_configs()[name]
    fired = _fired(cfg, bulk)
    if name in REFUSED_TRIDIAG_ROUTES:
        from roms_tpu_torch import convert
        from roms_tpu_torch.core.stepping import _check_config
        from torch_port_util import cfg_dict
        assert "tridiag" in fired
        fired = fired - {"tridiag"}
        with pytest.raises(NotImplementedError):
            _check_config(convert.config_from_dict(cfg_dict(cfg)))
    assert _port_fired(cfg, bulk) == fired
    if name in ("upwelling_gls", "upwelling_my25"):
        assert fired == _fired(_gate_configs()["upwelling"][0]) | {
            "tridiag"}
    elif name == "upwelling_gls_ns_periodic":
        assert fired == {"rho", "vdiff", "tridiag"}
    elif name.startswith("upwelling"):
        assert len(fired) == 9
    if name == "benchmark3_full_physics":
        assert fired == BENCHMARK3_FULL
    if name == "benchmark3_light":
        assert fired == BENCHMARK3_FULL - {"prep", "bulk"} | {"rho"}
    if name in ("benchmark3_bkpp", "benchmark3_ddmix"):
        # the whole-array LMD route: kernel 1's EOS in place of prep, and
        # kernel 17 for the spline shear
        assert fired == BENCHMARK3_FULL - {"prep"} | {"rho", "tridiag"}


@pytest.mark.parametrize("name", ["upwelling", "upwelling_full_width",
                                  "benchmark3_full_physics", "double_gyre"])
def test_blocked_engine_gates_match_roms_tpu(monkeypatch, name):
    """Under ROMS_TPU_PALLAS_STEP2D=1 with ROMS_TPU_FASTLOOP_RES=0
    roms_tpu's channel step runs the j-blocked engine in place of the
    resident one; the port's gates with engine "blocked" fire the same
    set.  Neither engine fires on the closed basin."""
    for var in [v for v in os.environ if v.startswith("ROMS_TPU_")]:
        monkeypatch.delenv(var)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    cfg, bulk = _gate_configs()[name]
    default = _fired(cfg, bulk)
    monkeypatch.setenv("ROMS_TPU_PALLAS_STEP2D", "1")
    monkeypatch.setenv("ROMS_TPU_FASTLOOP_RES", "0")
    fired = _fired(cfg, bulk)
    if name == "double_gyre":
        assert fired == default
        assert not fired & {"fast_loop_pallas_res", "fast_loop_pallas"}
    else:
        assert "fast_loop_pallas_res" in default
        assert fired == default - {"fast_loop_pallas_res"} | {
            "fast_loop_pallas"}
    assert _port_fired(cfg, bulk, engine="blocked") == fired
