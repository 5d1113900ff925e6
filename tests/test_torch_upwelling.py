"""Slice 2 of roms_tpu_torch, the EW-periodic UPWELLING channel, against
roms_tpu on the CPU: float64, inputs from a numpy seed on a small
UPWELLING grid (Vtransform 2 / Vstretching 4), zonally varying so that
errors at the periodic seam cannot cancel.

- each new kernel's plain version (what its wrapper runs on CPU tensors)
  against the Pallas kernel run as roms_tpu's own tests run it
  (interpret=True), relative 1e-12, over the rows the Pallas docstrings
  do not call dead; and against roms_tpu's jnp functions over whole
  arrays, which is the convention the CUDA kernels keep;
- the plain fast loop (16 carry fields) against roms_tpu's jnp substep
  loop, the reference of the resident Pallas engine;
- the five slice-1 entry points' plain versions on the periodic grid
  against their Pallas kernels;
- a 3-step UPWELLING trajectory of the port against roms_tpu within the
  cross-engine bound 1e-10*max|x| + 5e-14.

The CUDA kernels themselves need a card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from roms_tpu.core import hmix, prsgrd, stepping
from roms_tpu.core.omega import omega
from roms_tpu.core.rho_eos import rho_eos
from roms_tpu.core.step2d import make_substep_kernels
from roms_tpu.core.weights import power_law_weights
from roms_tpu.functionals import upwelling as up
from roms_tpu.grid.depth import set_depth, set_massflux
from roms_tpu.ops import (pallas_flux, pallas_prsgrd, pallas_rhs3d,
                          pallas_tadv, pallas_uv, pallas_uvmix, stencil as st)
from roms_tpu_torch.core import stepping as tstepping
from roms_tpu_torch.functionals import upwelling as tup
from roms_tpu_torch.ops import flux as tflux, prsgrd as tprsgrd
from roms_tpu_torch.ops import rhs3d as trhs3d, step2d as tstep2d
from roms_tpu_torch.ops import tadv as ttadv, uv as tuv, uvmix as tuvmix

from torch_port_util import port, reference_run, rel_err, t2n
from torch_port_util import xla_fast_compiles  # noqa: F401

TOL = 1e-12
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")


def _t(x):
    if isinstance(x, (list, tuple)):
        return [_t(y) for y in x]
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def uc():
    """UPWELLING at Lm=12, Mm=14, N=6 with seeded, zonally varying
    fields whose periodic lanes hold their copies, as in a model state;
    JAX arrays plus the config/grid of both packages."""
    torch.set_num_threads(1)
    cfg = up.make_config(Lm=12, Mm=14, N=6, dtype="float64")
    grid = up.make_grid(cfg)
    s = up.make_initial(cfg, grid)
    rng = np.random.default_rng(2025)
    N, (Mj, Li), NT = cfg.N, cfg.shape2d, cfg.NT

    def r(*shape, scale=1.0):
        return st.periodic_x(jnp.asarray(scale * rng.standard_normal(shape)))

    z_r, z_w, Hz = set_depth(grid, r(Mj, Li, scale=0.05))
    u = r(N, Mj, Li, scale=0.1) * grid.umask
    v = r(N, Mj, Li, scale=0.1) * grid.vmask
    Huon, Hvom = set_massflux(grid, u, v, Hz)
    Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
    t = s.t + r(NT, N, Mj, Li, scale=0.1)
    rho, _, rhoA, rhoS, _ = rho_eos(cfg, t, z_r, Hz, z_w)
    D = jnp.sum(Hz, axis=0)
    a = dict(
        z_r=z_r, z_w=z_w, Hz=Hz, u=u, v=v, Huon=Huon, Hvom=Hvom, t=t,
        W=omega(cfg, grid, Huon, Hvom, z_w), rho=rho, rhoA=rhoA, rhoS=rhoS,
        t_prev=t + r(NT, N, Mj, Li, scale=0.01),
        ru=r(N, Mj, Li), rv=r(N, Mj, Li),
        Akv=1e-3 * jnp.abs(r(N + 1, Mj, Li)) + 1e-5,
        avg=[r(Mj, Li, scale=0.01) * D * m
             for m in (grid.on_u, grid.om_v, grid.on_u, grid.om_v)],
        zeta=r(Mj, Li, scale=0.05),
        ubar=r(Mj, Li, scale=0.05) * grid.umask,
        vbar=r(Mj, Li, scale=0.05) * grid.vmask,
        f2=[r(Mj, Li, scale=1e-5) * grid.om_u * grid.on_u
            for _ in range(6)])
    tcfg, tgrid = port(cfg, grid)
    return cfg, grid, tcfg, tgrid, a


def test_flux_omega_plain(uc):
    cfg, grid, tcfg, tgrid, a = uc
    args = [a[k] for k in ("u", "v", "Hz", "z_w")]
    got = tflux.flux_omega(tcfg, tgrid, *_t(args))
    # the jnp path over whole arrays: nothing is dead
    for r, g in zip((a["Huon"], a["Hvom"], a["W"]), got):
        assert rel_err(r, g) < TOL
    # the Pallas kernel: its Huon/Hvom ring rows hold other dead values
    pal = pallas_flux.flux_omega_pallas(cfg, grid, *args, interpret=True)
    for r, g in zip(pal[:2], got[:2]):
        assert rel_err(r, g, np.s_[:, 1:-1, :]) < TOL
    assert rel_err(pal[2], got[2]) < TOL


def test_omega_plain(uc):
    cfg, grid, tcfg, tgrid, a = uc
    args = [a[k] for k in ("Huon", "Hvom", "z_w")]
    got = tflux.omega(tcfg, tgrid, *_t(args))
    assert rel_err(omega(cfg, grid, *args), got) < TOL
    pal = pallas_flux.omega_pallas(cfg, grid, *args, interpret=True)
    assert rel_err(pal, got) < TOL


def test_prsgrd32_plain(uc):
    cfg, grid, tcfg, tgrid, a = uc
    args = [a[k] for k in ("rho", "z_r", "z_w", "Hz")]
    got = tprsgrd.prsgrd32(tcfg, tgrid, *_t(args))
    ref = prsgrd.prsgrd32(cfg, grid, *args)
    pal = pallas_prsgrd.prsgrd32_pallas(cfg, grid, *args, interpret=True)
    # the Pallas kernel zeroes its ring rows, and its rv row 1 (a v-wall
    # row that bc_v zeroes) sees its own window edge instead of the wrap
    for r, p, g, j0 in zip(ref, pal, got, (1, 2)):
        assert rel_err(r, g) < TOL
        assert rel_err(p, g, np.s_[:, j0:-1, :]) < TOL


def test_uv3dmix2_s_plain(uc):
    cfg, grid, tcfg, tgrid, a = uc
    args = [a["u"], a["v"], a["Hz"] * a["u"], a["Hz"] * a["v"], a["Hz"],
            a["f2"][0], a["f2"][1]]
    got = tuvmix.uv3dmix2_s(tcfg, tgrid, *_t(args))
    ref = hmix.uv3dmix2_s(cfg, grid, *args)
    pal = pallas_uvmix.uv3dmix2_s_pallas(cfg, grid, *args, interpret=True)
    for r, p, g in zip(ref, pal, got):
        assert rel_err(r, g) < TOL
        # rows 0, 1 and Mj-1 are dead in the Pallas kernel
        # (tests/test_pallas_uvmix.py)
        assert rel_err(p, g, np.s_[..., 2:-1, 1:-1]) < TOL


@pytest.fixture(scope="module")
def jnp_loop(uc):
    """roms_tpu's jnp substep loop (lax.scan of its predictor and
    corrector) for a short loop at the published barotropic step
    dt/ndtfast = 10 s, compiled once for every iic (a traced argument),
    with its inputs."""
    cfg, grid, tcfg, tgrid, a = uc
    cfg = cfg.replace(dt=60.0, ndtfast=6)
    nfast, w1, w2 = power_law_weights(cfg.ndtfast)
    f2 = a["f2"]
    dyn = [a["zeta"], a["ubar"], a["vbar"], f2[0], f2[1], a["rhoS"],
           a["rhoA"], f2[2], f2[3], f2[4], f2[5]]
    pred, corr, _, init = make_substep_kernels(
        cfg, nfast, jnp.asarray(w1), jnp.asarray(w2))

    @jax.jit
    def loop(iicj):
        def body(c, iif):
            zp, up_, vp, rz, ru, rv, rufc, rvfc, avg = pred(
                grid, iif, c, dyn[5], dyn[6], iicj, dyn[9], dyn[10], None)
            c = corr(grid, iif, c._replace(avg=avg), zp, up_, vp, rz, ru,
                     rv, rufc, rvfc, dyn[5], dyn[6], None)
            return c, None

        c0 = init(dyn[0], dyn[1], dyn[2], dyn[3], dyn[4], dyn[7], dyn[8])
        return lax.scan(body, c0, jnp.arange(1, nfast + 1,
                                             dtype=jnp.int32))[0]
    return loop, dyn, (nfast, w1, w2)


@pytest.mark.parametrize("iic", [0, 5])
def test_fast_loop_res_plain(uc, jnp_loop, iic):
    """The 16 carry fields after nfast substeps against roms_tpu's jnp
    substep loop (lax.scan of its predictor and corrector)."""
    tcfg, tgrid = uc[2].replace(dt=60.0, ndtfast=6), uc[3]
    loop, dyn, (nfast, w1, w2) = jnp_loop
    ref = loop(jnp.asarray(iic, jnp.int32))
    got = tstep2d.fast_loop_res(tcfg, tgrid, nfast, w1, w2, True,
                                *_t(dyn), iic)
    for r, g in zip(tuple(ref)[:11] + tuple(ref.avg),
                    tuple(got)[:11] + tuple(got.avg)):
        assert rel_err(r, g) < 1e-11


@pytest.mark.parametrize("uv_adv", [False, True])
def test_fast_loop_res_against_the_pallas_engine(uc, monkeypatch, uv_adv):
    """The plain fast loop against roms_tpu's resident Pallas engine in
    interpret mode (16 carry fields, zonally varying inputs).  Without
    2D advection they agree to roundoff.  With it the Pallas engine
    departs from its own jnp reference by ~1e-3: pallas_step2d.py:235
    takes the i-1 neighbour of DgDU in VFx where core/step2d.py:199 (and
    step2d_LF_AM3.h) take j-1, a fault that zonally uniform runs hide
    (ROADMAP Queue 3).  The port follows the jnp path; the second case
    pins the fault and is to assert agreement once the reference is
    fixed."""
    from roms_tpu.ops import pallas_step2d
    monkeypatch.setenv("ROMS_TPU_PALLAS_STEP2D_INTERPRET", "1")
    cfg, grid, tcfg, tgrid, a = uc
    cfg = cfg.replace(dt=60.0, ndtfast=6, uv_adv=uv_adv)
    tcfg = tcfg.replace(dt=60.0, ndtfast=6, uv_adv=uv_adv)
    nfast, w1, w2 = power_law_weights(cfg.ndtfast)
    f2 = a["f2"]
    dyn = [a["zeta"], a["ubar"], a["vbar"], f2[0], f2[1], a["rhoS"],
           a["rhoA"], f2[2], f2[3], f2[4], f2[5]]
    pal = pallas_step2d.fast_loop_pallas_res(
        cfg, grid, nfast, jnp.asarray(w1), jnp.asarray(w2), True, *dyn,
        jnp.asarray(5, jnp.int32))
    got = tstep2d.fast_loop_res(tcfg, tgrid, nfast, w1, w2, True,
                                *_t(dyn), 5)
    names = ("zeta", "zeta_prev", "ubar", "ubar_prev", "vbar", "vbar_prev",
             "rzeta_prev", "rubar_prev", "rvbar_prev", "rufrc", "rvfrc",
             "Zt", "DU1", "DV1", "DU2", "DV2")
    err = max(rel_err(pal[n], g) for n, g in zip(
        names, tuple(got)[:11] + tuple(got.avg)))
    if uv_adv:
        assert err > 1e-6
    else:
        assert err < 1e-11


# --------------------------------------------------------------------------
# the slice-1 entry points on the EW-periodic grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["predictor", "corrector"])
def test_tadv_periodic_plain(uc, monkeypatch, mode):
    monkeypatch.setenv("ROMS_TPU_PALLAS_TADV_INTERPRET", "1")
    cfg, grid, tcfg, tgrid, a = uc
    if mode == "predictor":
        args = [a[k] for k in ("t", "t_prev", "Huon", "Hvom", "W", "Hz")]
        sc = ((1.0 - 1.0 / 6.0) * cfg.dt, 0.5 + 1.0 / 6.0, 0.5 - 1.0 / 6.0)
        ref = pallas_tadv.predictor_pallas(cfg, grid, *args,
                                           *[jnp.asarray(x) for x in sc])
        got = ttadv.predictor(tcfg, tgrid, *_t(args), *sc)
    else:
        args = [a["t"], a["Hz"][None] * a["t"]] + [
            a[k] for k in ("Huon", "Hvom", "W", "Hz")]
        ref = pallas_tadv.corrector_pallas(cfg, grid, *args)
        got = ttadv.corrector(tcfg, tgrid, *_t(args))
    assert rel_err(ref, got, np.s_[..., 1:-1, :]) < TOL


def test_rhs3d_periodic_plain(uc):
    cfg, grid, tcfg, tgrid, a = uc
    args = [a[k] for k in ("u", "v", "Hz", "Huon", "Hvom", "W", "ru", "rv")]
    got = trhs3d.rhs3d_momentum(tcfg, tgrid, *_t(args))
    pal = pallas_rhs3d.rhs3d_momentum_pallas(cfg, grid, *args,
                                             interpret=True)
    # the Pallas rv differs in its v-wall row 1 and its periodic lanes,
    # which bc_v overwrites (tests/test_torch_kernels.py compares the
    # closed basin over the same rows)
    assert rel_err(pal[0], got[0], np.s_[:, 1:-1, :]) < TOL
    assert rel_err(pal[1], got[1], np.s_[:, 2:-1, 1:-1]) < TOL


def test_uv_periodic_plain(uc):
    cfg, grid, tcfg, tgrid, a = uc
    Hz = a["Hz"]
    args = [a["u"] * Hz, a["v"] * Hz, 1e-2 * a["ru"], 1e-2 * a["rv"], Hz,
            a["Akv"]]
    cffab = 0.25 * cfg.dt * 23.0 / 12.0
    ref = pallas_uv.uv_solve_pallas(cfg, grid, *args, cffab, a["avg"][0],
                                    a["avg"][1], interpret=True)
    got = tuv.uv_solve(tcfg, tgrid, *_t(args), cffab, *_t(a["avg"][:2]))
    for r, g in zip(ref, got):
        assert rel_err(r, g) < TOL
    args = [a[k] for k in ("u", "v", "Hz", "Huon", "Hvom")] + a["avg"]
    ref = pallas_uv.uv_finish_pallas(cfg, grid, *args, interpret=True)
    got = tuv.uv_finish(tcfg, tgrid, *_t(args))
    for r, g in zip(ref, got):
        assert rel_err(r, g) < TOL


# --------------------------------------------------------------------------
# the slice: a UPWELLING trajectory
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """3 steps of both packages from the published initial state plus a
    seeded zonally varying perturbation of u and t."""
    torch.set_num_threads(1)
    cfg = up.make_config(Lm=10, Mm=12, N=5, dtype="float64")
    grid = up.make_grid(cfg)
    s0 = up.make_initial(cfg, grid)
    rng = np.random.default_rng(3)
    s0 = s0._replace(
        u=s0.u + jnp.asarray(0.01 * rng.standard_normal(s0.u.shape))
        * grid.umask,
        t=s0.t + jnp.asarray(0.1 * rng.standard_normal(s0.t.shape)))
    ref = reference_run(stepping.Model(
        cfg, grid, up.make_forcing_fn(cfg, grid),
        vmix_fn=up.make_vmix_fn(cfg)), s0, 3)
    tcfg, tgrid, ts0 = port(cfg, grid, s0)
    model = tstepping.Model(tcfg, tgrid, tup.make_forcing_fn(tcfg, tgrid),
                            vmix_fn=tup.make_vmix_fn(tcfg))
    return ref, model.run(ts0, 3), cfg, grid, tcfg, tgrid


@pytest.mark.parametrize("field", FIELDS)
def test_trajectory_matches_roms_tpu(runs, field):
    ref, got = runs[:2]
    x = np.asarray(getattr(ref, field))
    y = t2n(getattr(got, field))
    assert np.isfinite(y).all()
    scale = np.abs(x).max() + 1e-30
    assert np.abs(y - x).max() < 1e-10 * scale + 5e-14, \
        (field, np.abs(y - x).max(), scale)


def test_port_functionals_match_roms_tpu(runs):
    """The port's own UPWELLING grid, initial state, wind and vmix equal
    roms_tpu's."""
    _, _, cfg, grid, tcfg, tgrid = runs
    g = tup.make_grid(tcfg, device="cpu")
    for name in ("h", "pm", "pn", "f", "on_u", "om_v", "pmask", "Cs_r"):
        assert rel_err(getattr(grid, name), getattr(g, name)) < TOL
    s, ts = up.make_initial(cfg, grid), tup.make_initial(tcfg, g)
    for name in ("t", "z_r", "z_w", "Hz"):
        assert rel_err(getattr(s, name), getattr(ts, name)) < TOL
    for time in (0.0, 3600.0, 3.0 * 86400.0):
        assert rel_err(up.make_forcing_fn(cfg, grid)(time).sustr,
                       tup.make_forcing_fn(tcfg, g)(time).sustr) < TOL
    Akv, Akt = up.make_vmix_fn(cfg)(s, grid, s.z_w)
    tAkv, tAkt = tup.make_vmix_fn(tcfg)(ts, g, ts.z_w)
    assert rel_err(Akv, tAkv) < TOL and rel_err(Akt, tAkt) < TOL


def test_upwelling_grid_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tup.make_grid(tup.make_config(Lm=6, Mm=8, N=4))

