"""The port's deck driver, `python -m roms_tpu_torch DECK`, against
roms_tpu's `python -m roms_tpu DECK` on the CPU (float64):

(a) one inline UPWELLING deck in the reference format with HIS, QCK,
    AVG, RST, STA and NINFO through both drivers, both starting from
    record NRREC = 1 of an ININAME file that the port wrote (the state 2
    steps in; record 2 holds another state): every file's variable
    names, dimensions and record count equal, values within the bound
    of tests/test_correctness_gates.py:65 (1e-10*max|x| + 5e-14), the
    NINFO numbers within 1e-8 relative;
(b) restart: 3 steps, read_restart, 3 more equal 6 steps bit for bit;
    the port reads the RST file roms_tpu's driver wrote in (a), and
    roms_tpu reads the port's;
(c) an LMD_TEST deck (doubly periodic, LMD_BKPP) with HIS and NINFO
    through both drivers, HIS within the same bound, NINFO within 1e-8;
(d) the refusals: apps the port cannot run (CHANNEL_NECK must not run
    as CHANNEL), --mesh, and a deck naming an
    existing GRDNAME file raise NotImplementedError naming their
    ROADMAP Queue 1 item; strict keyword checking raises RomsError on a
    keyword roms_tpu does not know either; --device cuda raises without
    a card.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from roms_tpu import __main__ as jdriver
from roms_tpu_torch import __main__ as tdriver
from roms_tpu_torch.core.stepping import Model
from roms_tpu_torch.functionals import upwelling as tup
from roms_tpu_torch.io.rst_netcdf import RestartWriter, read_restart

from torch_port_util import xla_fast_compiles  # noqa: F401

LBC = "\n".join(f"   LBC({v}) == Per Clo Per Clo"
                for v in ("isFsur", "isUbar", "isVbar", "isUvel", "isVvel",
                          "isTvar", "isMtke"))

DECK = f"""
! UPWELLING in the reference roms.in format (read_phypar.F keywords)
       TITLE = Wind-Driven Upwelling/Downwelling over a Periodic Channel
    MyAppCPP = UPWELLING
          Lm == 41
          Mm == 80
           N == 16
{LBC}
      NTIMES == 6
          DT == 300.0d0
     NDTFAST == 30
  Vtransform == 2
 Vstretching == 4
     THETA_S == 3.0d0
     THETA_B == 0.0d0
      TCLINE == 25.0d0
        RHO0 == 1025.0d0
          R0 == 1027.0d0
          T0 == 14.0d0
          S0 == 35.0d0
       TCOEF == 1.7d-4
       SCOEF == 0.0d0
      GAMMA2 == 1.0d0
        TNU2 == 2*0.0d0
       VISC2 == 5.0d0
     AKV_BAK == 1.0d-5
     AKT_BAK == 1.0d-6 1.0d-6
        RDRG == 3.0d-04
       NINFO == 2
        NHIS == 2
        NQCK == 3
        NAVG == 3
        NRST == 3
        NSTA == 1
   LcycleRST == T
     HISNAME == roms_his.nc
     QCKNAME == roms_qck.nc
     AVGNAME == roms_avg.nc
     RSTNAME == roms_rst.nc
     STANAME == roms_sta.nc
     SPOSNAM == {{spos}}
     GRDNAME == roms_grd_absent.nc
     ININAME == roms_ini.nc
       NRREC == 1
Hout(idFsur) == T
Hout(idUbar) == T
Hout(idVbar) == T
Hout(idUvel) == T
Hout(idVvel) == T
Hout(idWvel) == T
Hout(idOvel) == T
Hout(idTvar) == T T
Hout(idDano) == T
Hout(idUsms) == T
Hout(idUbms) == T
Hout(idVvis) == T
Aout(idFsur) == T
Aout(idUvel) == T
Aout(idTvar) == T T
Aout(idOvel) == T
"""

STATIONS = """
! stations deck (read_stapar.F format)
    NSTATION ==  3
Sout(idFsur) == T
Sout(idUvel) == T
Sout(idTvar) == T
POS =  GRID  FLAG      X-POS       Y-POS     COMMENT
        1    0        3.0         4.0
        1    0        6.0         9.0
        1    0       11.0        14.0
"""

SIZE = ["--dtype", "float64", "--lm", "12", "--mm", "16", "--n", "4",
        "--ntimes", "6"]
FILES = ("roms_his.nc", "roms_qck.nc", "roms_avg.nc", "roms_rst.nc",
         "roms_sta.nc")
# perfect-restart histories of the RHS and the 2D coupling forcing: their
# ring rows j = 0 and Mj-1 are dead data, which the port's rhs3d and tadv
# (kernels and plain versions) zero where roms_tpu's jnp path leaves
# roll-wrap values (ROADMAP Queue 3, known deliberate differences)
RING_DEAD = {"ru_prev", "rv_prev", "ru_prev2", "rv_prev2", "ru0_prev",
             "rv0_prev", "ru0_prev2", "rv0_prev2"}


def _deck(tmp, **over):
    spos = tmp / "stations.in"
    spos.write_text(STATIONS)
    text = DECK.replace("{spos}", str(spos))
    for key, val in over.items():
        text = re.sub(rf"^\s*{re.escape(key)} =+ .*$", f"{key} == {val}",
                      text, flags=re.M)
    path = tmp / "roms_test.in"
    path.write_text(text)
    return str(path)


def _ninfo(out):
    """The NINFO table's lines, each as (iic, KE, PE, KE+PE, volume,
    Courant, vertical Courant, max speed)."""
    num = r"-?\d\.\d+E[+-]\d+"
    lines = out.splitlines()
    rows = []
    for a, b in zip(lines, lines[1:]):
        if re.fullmatch(rf"\s*\d+(\s+{num}){{4}}", a) and \
                re.fullmatch(rf"\s*({num}\s*){{3}}", b):
            rows.append([float(x) for x in a.split() + b.split()])
    return np.array(rows)


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """Both drivers on the same deck: {"jax"/"torch": (outdir, stdout),
    "run": the port driver's DeckRun}."""
    tmp = tmp_path_factory.mktemp("deck")
    deck = _deck(tmp, ININAME=str(tmp / "roms_ini.nc"))
    # the ININAME file: record 1 the state 2 steps in, record 2 the
    # analytical initial state
    model, cfg, grid = _deck_model(deck)
    s0 = tup.make_initial(cfg, grid)
    w = RestartWriter(str(tmp / "roms_ini.nc"), cfg, grid, cycle=0)
    w.write(model.run(s0, 2)._replace(iic=0, time=0.0))
    w.write(s0)
    w.close()
    out = {}
    for name in ("jax", "torch"):
        argv = [deck, "--outdir", str(tmp / name)] + SIZE
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if name == "jax":
                assert jdriver.main(argv) == 0
            else:
                out["run"] = tdriver.run(argv + ["--device", "cpu"])
                assert out["run"].code == 0
        out[name] = (tmp / name, buf.getvalue())
    return tmp, out


def test_deck_files_match_roms_tpu(decks):
    """HIS/QCK/AVG/RST/STA: names, dims, record counts, values; NINFO."""
    _, out = decks
    (jd, jout), (td, tout) = out["jax"], out["torch"]
    for fname in FILES:
        a = netcdf_file(jd / fname, "r", mmap=False)
        b = netcdf_file(td / fname, "r", mmap=False)
        assert sorted(a.variables) == sorted(b.variables), fname
        assert a.dimensions == b.dimensions, fname
        for name, va in a.variables.items():
            vb = b.variables[name]
            assert va.dimensions == vb.dimensions, (fname, name)
            assert va.shape == vb.shape, (fname, name)
            assert va.data.dtype == vb.data.dtype, (fname, name)
            x = np.asarray(va.data, np.float64)
            y = np.asarray(vb.data, np.float64)
            if name in RING_DEAD:
                x, y = x[..., 1:-1, :], y[..., 1:-1, :]
            assert np.isfinite(y).all(), (fname, name)
            scale = np.abs(x).max(initial=0.0)
            tol = 1e-10 * scale + 5e-14
            if va.data.dtype == np.float32:
                # a float32 record is its float64 field rounded once: two
                # fields within the bound may round to neighbouring
                # float32 values, one spacing apart at that value
                tol = tol + np.spacing(np.abs(x).astype(np.float32))
            assert np.all(np.abs(x - y) <= tol), \
                (fname, name, np.abs(x - y).max(initial=0.0), scale)
        a.close()
        b.close()
    nrec = {f: netcdf_file(td / f, "r", mmap=False).variables[
        "ocean_time"].shape[0] for f in FILES}
    assert nrec == {"roms_his.nc": 3, "roms_qck.nc": 2, "roms_avg.nc": 2,
                    "roms_rst.nc": 2, "roms_sta.nc": 6}
    ja, ta = _ninfo(jout), _ninfo(tout)
    assert ja.shape == ta.shape == (3, 8), (ja.shape, ta.shape)
    assert list(ta[:, 0]) == [2, 4, 6]
    assert np.all(np.abs(ta - ja) <= 1e-8 * np.abs(ja)), (ja, ta)
    his = netcdf_file(td / "roms_his.nc", "r", mmap=False)
    assert {"w", "omega", "rho", "sustr", "bustr", "AKv", "temp",
            "salt"} <= set(his.variables)
    his.close()
    assert "unsupported" not in tout
    assert "initial state from file" in jout
    assert "initial state from file" in tout

    # the blowup report of the NINFO table (diag.F / mod_scalars.F)
    from roms_tpu_torch.core.diag import blowup_string, diag
    run = out["run"]
    cfg, grid, s = run.model.cfg, run.model.grid, run.state
    d = diag(cfg, grid, s, use_kernels=False)
    assert int(d.exit_flag) == 0 and int(d.blowup_cause) == 0
    d = diag(cfg, grid, s._replace(u=s.u + 30.0))
    assert (int(d.exit_flag), int(d.blowup_cause)) == (1, 2)
    assert "cause=max |v| exceeded" in blowup_string(d)
    zeta = s.zeta.clone()
    zeta[3, 4] = float("nan")
    d = diag(cfg, grid, s._replace(zeta=zeta))
    assert (int(d.exit_flag), int(d.blowup_cause)) == (1, 1)


def _deck_model(deck):
    """The port's Model, grid and cfg of the UPWELLING deck at SIZE."""
    from roms_tpu_torch.io.roms_in import parse_roms_in, to_config
    cfg = to_config(parse_roms_in(deck), Lm=12, Mm=16, dtype="float64")
    cfg = cfg.replace(vert=cfg.vert.__class__(
        **{**cfg.vert.__dict__, "N": 4}))
    grid = tup.make_grid(cfg, device="cpu")
    return Model(cfg, grid, tup.make_forcing_fn(cfg, grid),
                 vmix_fn=tup.make_vmix_fn(cfg)), cfg, grid


LMD_DECK = """
! LMD_TEST in the reference roms.in format: a doubly periodic box with
! LMD-KPP and its bottom boundary layer (lmd_test.h)
       TITLE = Wind-Driven Mixed Layer Deepening, LMD-KPP
    MyAppCPP = LMD_TEST
          Lm == 10
          Mm == 10
           N == 50
""" + "\n".join(f"   LBC({v}) == Per Per Per Per"
                for v in ("isFsur", "isUbar", "isVbar", "isUvel", "isVvel",
                          "isTvar", "isMtke")) + """
      NTIMES == 4
          DT == 300.0d0
     NDTFAST == 30
  Vtransform == 1
 Vstretching == 1
     THETA_S == 3.0d0
     THETA_B == 0.0d0
      TCLINE == 50.0d0
        RHO0 == 1025.0d0
      GAMMA2 == 1.0d0
        TNU2 == 2*0.0d0
       VISC2 == 0.0d0
       NINFO == 1
        NHIS == 2
     HISNAME == roms_his.nc
     GRDNAME == roms_grd_absent.nc
Hout(idFsur) == T
Hout(idUvel) == T
Hout(idVvel) == T
Hout(idTvar) == T T
Hout(idVvis) == T
Hout(idTdif) == T
Hout(idSdif) == T
Hout(idHsbl) == T
Hout(idHbbl) == T
Hout(idUsms) == T
Hout(idUbms) == T
"""


def test_lmd_test_deck_matches_roms_tpu(tmp_path):
    """An LMD_TEST deck (doubly periodic, LMD-KPP with LMD_BKPP, HIS with
    the mixing coefficients and both boundary-layer depths, NINFO every
    step) through both drivers at 8 x 6 x 12, float64: the HIS file's
    variables, dimensions and records within the trajectory bound, and
    the NINFO table within 1e-8 relative.  LAB_CANYON runs as itself, not
    as CANYON."""
    from roms_tpu_torch.functionals import idealized as tia
    assert tdriver._app_module("LAB_CANYON")[0] is tia.lab_canyon_config
    deck = tmp_path / "roms_lmd_test.in"
    deck.write_text(LMD_DECK)
    size = ["--dtype", "float64", "--lm", "8", "--mm", "6", "--n", "12"]
    outs = {}
    for name, main in (("jax", jdriver.main), ("torch", tdriver.main)):
        argv = [str(deck), "--outdir", str(tmp_path / name)] + size
        if name == "torch":
            argv += ["--device", "cpu"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        outs[name] = buf.getvalue()
    a = netcdf_file(tmp_path / "jax" / "roms_his.nc", "r", mmap=False)
    b = netcdf_file(tmp_path / "torch" / "roms_his.nc", "r", mmap=False)
    assert sorted(a.variables) == sorted(b.variables)
    assert {"Hsbl", "Hbbl", "AKv", "AKt", "AKs", "bustr"} <= set(
        b.variables)
    assert a.dimensions == b.dimensions
    assert b.variables["ocean_time"].shape[0] == 2
    for name, va in a.variables.items():
        vb = b.variables[name]
        assert va.dimensions == vb.dimensions and va.shape == vb.shape, name
        x = np.asarray(va.data, np.float64)
        y = np.asarray(vb.data, np.float64)
        assert np.isfinite(y).all(), name
        tol = 1e-10 * np.abs(x).max(initial=0.0) + 5e-14
        if va.data.dtype == np.float32:
            tol = tol + np.spacing(np.abs(x).astype(np.float32))
        assert np.all(np.abs(x - y) <= tol), \
            (name, np.abs(x - y).max(initial=0.0))
    a.close()
    b.close()
    ja, ta = _ninfo(outs["jax"]), _ninfo(outs["torch"])
    assert ja.shape == ta.shape == (4, 8), (ja.shape, ta.shape)
    assert list(ta[:, 0]) == [1, 2, 3, 4]
    assert np.all(np.abs(ta - ja) <= 1e-8 * np.abs(ja)), (ja, ta)
    assert "unsupported" not in outs["torch"]


def test_restart_is_bitwise(decks, tmp_path):
    """3 steps, RST, read_restart, 3 more == 6 steps bit for bit, with
    the GLS turbulence fields riding along; the port continues from the
    RST file roms_tpu's driver wrote as from its own, and roms_tpu reads
    the port's."""
    import dataclasses
    tmp, out = decks
    cfg = tup.make_config(Lm=12, Mm=16, N=4, dtype="float64")
    cfg = cfg.replace(mixing=dataclasses.replace(
        cfg.mixing, vmix="gls", gls_stab="kantha_clayson"))
    grid = tup.make_grid(cfg, device="cpu")
    model = Model(cfg, grid, tup.make_forcing_fn(cfg, grid))
    s0 = tup.make_initial(cfg, grid)
    s3 = model.run(s0, 3)
    w = RestartWriter(str(tmp_path / "rst.nc"), cfg, grid)
    w._ensure_mix_vars(s0.mix)
    w.write(s3)
    w.close()
    r3 = read_restart(str(tmp_path / "rst.nc"), cfg, grid, template=s0)
    assert r3.iic == 3 and r3.time == s3.time
    a, b = model.run(s3, 3), model.run(r3, 3)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "mix":
            for g in x._fields:
                assert torch.equal(getattr(x, g), getattr(y, g)), g
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f
        else:
            assert x == y, f

    # roms_tpu's RST of the deck run, read by the port
    (jd, _), (td, _) = out["jax"], out["torch"]
    model, cfg, grid = _deck_model(str(tmp / "roms_test.in"))
    sj = read_restart(str(jd / "roms_rst.nc"), cfg, grid)
    st = read_restart(str(td / "roms_rst.nc"), cfg, grid)
    assert sj.iic == st.iic == 6 and sj.time == st.time
    f = netcdf_file(jd / "roms_rst.nc", "r", mmap=False)
    rec = int(np.argmax(f.variables["nsteps"].data))
    assert np.array_equal(sj.u.numpy(), f.variables["u"].data[rec])
    f.close()
    aj, at = model.step(sj), model.step(st)
    for name in ("zeta", "ubar", "vbar", "u", "v", "t"):
        x, y = getattr(aj, name).numpy(), getattr(at, name).numpy()
        scale = np.abs(x).max()
        assert np.abs(x - y).max() <= 1e-10 * scale + 5e-14, name

    # roms_tpu reads the port's RST file as the port does
    from roms_tpu.io.rst_netcdf import read_restart as jread_restart
    from roms_tpu.io.roms_in import parse_roms_in, to_config
    jcfg = to_config(parse_roms_in(str(tmp / "roms_test.in")), Lm=12,
                     Mm=16, dtype="float64")
    jcfg = jcfg.replace(vert=jcfg.vert.__class__(
        **{**jcfg.vert.__dict__, "N": 4}))
    rj = jread_restart(str(td / "roms_rst.nc"), jcfg, None)
    assert int(rj.iic) == 6 and float(rj.time) == st.time
    for name in st._fields:
        x = getattr(st, name)
        if isinstance(x, torch.Tensor):
            y = np.asarray(getattr(rj, name))
            assert y.dtype == x.numpy().dtype, name
            assert np.array_equal(y, x.numpy()), name


REFUSED = {"CHANNEL_NECK": "item 7", "KELVIN": "item 6",
           "BIO_TOY": "item 8"}


def test_driver_refusals(tmp_path, monkeypatch):
    """Apps, options and input files the port does not run raise
    NotImplementedError naming their ROADMAP Queue 1 item before any
    step; `--device cuda` raises without a card."""
    # the port's table knows every application key of roms_tpu's driver
    import inspect
    jkeys = set(re.findall(r'^\s+"([A-Z0-9_]+)": \(',
                           inspect.getsource(jdriver._app_module), re.M))
    tkeys = set(re.findall(r'^\s+"([A-Z0-9_]+)": \(',
                           inspect.getsource(tdriver._app_module), re.M))
    assert len(jkeys) == 34 and jkeys == tkeys | set(tdriver._UNPORTED)
    args = ["--device", "cpu", "--outdir", str(tmp_path)] + SIZE
    for app, item in REFUSED.items():
        deck = _deck(tmp_path, MyAppCPP=app)
        with pytest.raises(NotImplementedError,
                           match=f"{app}.*ROADMAP Queue 1 {item}"):
            tdriver.main([deck] + args)
    deck = _deck(tmp_path)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tdriver.main([deck, "--mesh", "1x2"] + args)
    grd = tmp_path / "roms_grd.nc"
    grd.write_bytes(b"")
    deck = _deck(tmp_path, GRDNAME=str(grd))
    with pytest.raises(NotImplementedError,
                       match="GRDNAME.*ROADMAP Queue 1 item 6"):
        tdriver.main([deck] + args)
    # strict keyword checking (read_phypar.F's unknown-keyword stop)
    from roms_tpu.io import roms_in as jroms_in
    from roms_tpu_torch.core.errors import RomsError
    from roms_tpu_torch.io import roms_in as troms_in
    bad = tmp_path / "roms_bad.in"
    bad.write_text(open(deck).read() + "\n  NOT_A_KEYWORD == 1\n")
    params = troms_in.parse_roms_in(str(bad))
    assert troms_in.check_keywords(params) == jroms_in.check_keywords(
        jroms_in.parse_roms_in(str(bad))) == ["NOT_A_KEYWORD"]
    with pytest.raises(RomsError, match="exit_flag=7.*NOT_A_KEYWORD"):
        troms_in.to_config(params, strict=True)
    assert troms_in.to_config(troms_in.parse_roms_in(deck), strict=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdriver.main([_deck(tmp_path), "--outdir", str(tmp_path)] + SIZE)
    # every refusal came before any output stream was opened
    assert [f.name for f in tmp_path.glob("*.nc")] == ["roms_grd.nc"]
