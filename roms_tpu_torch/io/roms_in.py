"""Reader for reference-format `roms_*.in` input scripts (a copy of
roms_tpu/io/roms_in.py on the port's own config.py).

Provides a migration path for users of the reference model: their
standard-input files (the `keyword == value` format decoded by
ROMS/Utility/inp_par.F + read_phypar.F) parse directly into a
`ModelConfig`.

Supported syntax:
  - `KEY == value [value ...]`   (plural assignment)
  - `KEY = value`                (singular assignment)
  - `!` comments, blank lines
  - Fortran double literals (`3.0d-4`), logicals (`T`/`F`)
  - repetition counts (`2*0.0d0`)
  - `LBC(isFsur) == Per Clo Per Clo` edge specs (order W S E N,
    read_phypar.F keyword tables)

Unrecognized keywords are retained in the returned dict so callers can
inspect application-specific entries; `to_config` maps the physics
subset onto the native dataclass tree.  `strict=True` raises
RomsError(ILLEGAL_INPUT) for any keyword stem outside the recognized
vocabulary (read_phypar.F's behavior for bad keys), so a reference deck
cannot silently configure physics the model then doesn't run.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Union

from .. import config as C
from ..core.errors import ExitFlag, RomsError

_COMMENT = re.compile(r"!.*$")
_ASSIGN = re.compile(r"^\s*([A-Za-z0-9_()\s]+?)\s*==?\s*(.*)$")


def _parse_value(tok: str) -> Union[float, int, bool, str]:
    t = tok.strip()
    if t in ("T", ".true.", ".TRUE."):
        return True
    if t in ("F", ".false.", ".FALSE."):
        return False
    ft = t.replace("d", "e").replace("D", "e")
    try:
        if re.fullmatch(r"[+-]?\d+", t):
            return int(t)
        return float(ft)
    except ValueError:
        return t


def _expand(tokens: List[str]) -> List:
    out = []
    for tok in tokens:
        m = re.fullmatch(r"(\d+)\*(.+)", tok)
        if m:
            out.extend([_parse_value(m.group(2))] * int(m.group(1)))
        else:
            out.append(_parse_value(tok))
    return out


def parse_roms_in(text_or_path: str) -> Dict:
    """Parse a roms.in script (path or raw text) into {keyword: value}.

    Repeated keywords accumulate into lists (multi-line plural values,
    e.g. per-tracer Hadvection rows)."""
    if "\n" not in text_or_path and not text_or_path.lstrip().startswith("!"):
        with open(text_or_path) as fh:
            text = fh.read()
    else:
        text = text_or_path

    # join "\"-continued logical lines (read_phypar multi-line plural
    # values, e.g. per-tracer Hadvection rows)
    logical: List[str] = []
    pending = ""
    for raw in text.splitlines():
        line = _COMMENT.sub("", raw).strip()
        if not line:
            continue
        if line.endswith("\\"):
            pending += line[:-1].strip() + " "
            continue
        logical.append(pending + line)
        pending = ""
    if pending:
        logical.append(pending)

    params: Dict = {}
    for line in logical:
        m = _ASSIGN.match(line)
        if not m:
            continue
        key = re.sub(r"\s+", "", m.group(1))
        vals = _expand(m.group(2).split())
        if not vals:
            continue
        value = vals[0] if len(vals) == 1 else vals
        if key in params:
            prev = params[key]
            params[key] = (prev if isinstance(prev, list) else [prev])
            params[key] += vals
        else:
            params[key] = value
    return params


_LBC_KINDS = {
    "per": C.PERIODIC, "clo": C.CLOSED, "gra": C.GRADIENT,
    "cla": C.CLAMPED, "rad": C.RADIATION, "radnud": C.RADIATION,
    "fla": C.FLATHER, "che": C.CHAPMAN_EXPLICIT,
    "cha": C.CHAPMAN_IMPLICIT, "nes": C.GRADIENT, "shc": C.GRADIENT,
    "red": C.GRADIENT,
}


def _lbc(params: Dict, key: str) -> C.LBC:
    spec = params.get(key)
    if spec is None:
        return C.LBC()
    if not isinstance(spec, list):
        spec = [spec]
    kinds = [_LBC_KINDS.get(str(s).lower()[:3], C.CLOSED) for s in spec[:4]]
    while len(kinds) < 4:
        kinds.append(C.CLOSED)
    # "RadNud" = radiation + nudging toward boundary data (LBC%nudging)
    edges = ("west", "south", "east", "north")
    nudge = tuple(e for e, s in zip(edges, spec[:4])
                  if str(s).lower().startswith("radnud"))
    west, south, east, north = kinds
    return C.LBC(west=west, south=south, east=east, north=north,
                 nudge=nudge)


_HADV_MAP = {
    "u3": C.UPSTREAM3, "c2": C.CENTERED2, "c4": C.CENTERED4,
    "a4": C.AKIMA4, "sp": "splines", "hs": C.HSIMT, "mp": C.MPDATA,
    "su": C.SPLIT_U3,
}


def _adv_scheme(params: Dict, key: str, default: str) -> str:
    spec = params.get(key)
    if spec is None:
        return default
    if isinstance(spec, list):
        spec = spec[0]
    return _HADV_MAP.get(str(spec).lower()[:2], default)


def _adv_registry(params: Dict, key: str, default: str):
    """Per-tracer scheme tuple (tadv.F:146-180) or None if uniform."""
    spec = params.get(key)
    if spec is None or not isinstance(spec, list):
        return None
    schemes = tuple(_HADV_MAP.get(str(s).lower()[:2], default)
                    for s in spec)
    if all(s == schemes[0] for s in schemes):
        return None                      # uniform: use the global switch
    return schemes


def _first(v, default=None):
    if v is None:
        return default
    return v[0] if isinstance(v, list) else v


# Keyword-stem vocabulary (read_phypar.F keyword tables).  Stems are the
# keyword with any "(...)" index stripped.  "consumed" stems map onto
# ModelConfig here; "accepted" stems are run-control / file-name / output
# switches handled by the driver+IO layers (or deliberately inert, e.g.
# PIO tuning) — both are legal in strict mode.
_CONSUMED = {
    "Lm", "Mm", "N", "NAT", "NT", "DT", "NDTFAST", "Vtransform",
    "Vstretching", "THETA_S", "THETA_B", "TCLINE", "R0", "T0", "S0",
    "TCOEF", "SCOEF", "VISC2", "VISC4", "TNU2", "TNU4", "AKV_BAK",
    "AKT_BAK", "AKK_BAK", "AKP_BAK", "GLS_P", "GLS_M", "GLS_N",
    "GLS_CMU0", "GLS_C1", "GLS_C2", "GLS_C3M", "GLS_C3P", "GLS_SIGK",
    "GLS_SIGP", "GLS_Kmin", "GLS_Pmin", "ZOS", "Zos", "RDRG", "RDRG2",
    "Zob", "RHO0", "GAMMA2", "LBC", "Hadvection", "Vadvection",
    "DCRIT", "VolCons", "NTIMES",
    # nudging / sponge keywords (inp_par.F:697-753, get_nudgcoef.F)
    "TNUDG", "ZNUDG", "M2NUDG", "M3NUDG", "OBCFAC",
    "LuvSponge", "LtracerSponge",
    "LnudgeM2CLM", "LnudgeM3CLM", "LnudgeTCLM",
    # bulk-flux measurement heights / Jerlov water type / body-force
    # surface level (read_phypar.F blk_ZW..; lmd_swfrac.F Jwtype)
    "BLK_ZQ", "BLK_ZT", "BLK_ZW", "WTYPE", "LEVSFRC",
}
_ACCEPTED = {
    # run control / restart cadence / output cadence
    "TITLE", "MyAppCPP", "VARNAME", "NRREC", "NRST", "NHIS", "NQCK",
    "NAVG", "NDIA", "NSTA", "NFLT", "NINFO", "NTSAVG", "NTSDIA",
    "LDEFOUT", "LcycleRST", "LcycleADJ", "LcycleTLM", "DSTART",
    "TIME_REF", "NDEFHIS", "NDEFQCK", "NDEFAVG", "NDEFDIA", "NDEFADJ",
    "NDEFTLM", "NDEFXTR", "NXTR", "ExtractFlag", "NTIMES_ANA",
    "NTIMES_FCT", "NADJ", "NTLM", "NSFF", "NOBC", "NBCFILES",
    "NCLMFILES", "NFFILES", "NGCNAME", "NUSER", "USER", "INP_LIB",
    "OUT_LIB", "ERstr", "ERend", "Ngrids", "NestLayers",
    "GridsInLayer", "NtileI", "NtileJ",
    # tracer-family dimensions (mod_param NBT/NPT/NCS/NNS, Nbed)
    "Nbed", "NPT", "NCS", "NNS",
    # file names (io layer picks these up from the parsed dict)
    "GRDNAME", "ININAME", "IRPNAME", "ITLNAME", "IADNAME", "FRCNAME",
    "BRYNAME", "CLMNAME", "NUDNAME", "SSFNAME", "TIDENAME", "ADSNAME",
    "FWDNAME", "HISNAME", "QCKNAME", "RSTNAME", "AVGNAME", "DIANAME",
    "STANAME", "FLTNAME", "GSTNAME", "TLFNAME", "TLMNAME", "ADJNAME",
    "GRXNAME", "XTRNAME", "DAINAME", "HARNAME", "APARNAM", "BPARNAM",
    "SPARNAM", "IPARNAM", "SPOSNAM", "FPOSNAM", "USRNAME", "AVGBASE", "DIABASE",
    "FOInameA", "FOInameB", "FCTnameA", "FCTnameB",
    # output field switches
    "Hout", "Qout", "Aout", "Dout",
    # physics accepted but inert here (no corresponding model knob)
    "BVF_BAK", "AKT_LIMIT", "AKV_LIMIT", "TKENU2", "TKENU4",
    "CHARNOK_ALPHA", "CRGBAN_CW", "ZOS_HSIG_ALPHA", "SZ_ALPHA",
    "LEVBFRC",
    "WEC_ALPHA",
    "LuvSrc", "LwSrc", "LtracerSrc", "LsshCLM", "Lm2CLM",
    "Lm3CLM", "LtracerCLM", "TIDE_START", "Lnodal",
    # 4D-Var / GST / adjoint decks
    "Nouter", "Ninner", "Nintervals", "Nsaddle", "NEV", "NCV", "NGST",
    "Ritz_tol", "MaxIterGST", "LmultiGST", "LrstGST", "Lstate",
    "Fstate", "SO_decay", "SO_sdev", "KstrS", "KendS", "DstrS",
    "DendS", "ad_LBC", "ad_VISC2", "ad_VISC4", "ad_TNU2", "ad_TNU4",
    "ad_AKT_fac", "ad_AKV_fac", "ad_Hadvection", "ad_Vadvection",
    "ad_VolCons",
    # NetCDF / PIO tuning
    "NC_SHUFFLE", "NC_DEFLATE", "NC_DLEVEL", "PIO_METHOD",
    "PIO_IOTASKS", "PIO_STRIDE", "PIO_BASE", "PIO_AGGREG", "PIO_REARR",
    "PIO_REARRCOM", "PIO_REARRDIR", "PIO_C2I_HS", "PIO_C2I_Send",
    "PIO_C2I_Preq", "PIO_I2C_HS", "PIO_I2C_Send", "PIO_I2C_Preq",
}
_RECOGNIZED = _CONSUMED | _ACCEPTED


def check_keywords(params: Dict) -> List[str]:
    """Return the list of keyword stems not in the known vocabulary."""
    unknown = []
    for key in params:
        stem = re.sub(r"\(.*\)$", "", key)
        if stem not in _RECOGNIZED:
            unknown.append(key)
    return unknown


def to_config(params: Dict, strict: bool = False,
              **overrides) -> C.ModelConfig:
    """Map parsed roms.in parameters onto a ModelConfig.

    Keyword meanings follow read_phypar.F; anything the native config
    does not model is ignored unless strict=True, which raises
    RomsError(ILLEGAL_INPUT) on unknown keywords.  `overrides` are
    applied last via dataclasses.replace."""
    if strict:
        unknown = check_keywords(params)
        if unknown:
            raise RomsError(ExitFlag.ILLEGAL_INPUT,
                            "unknown keywords: " + ", ".join(unknown))
    g = params.get

    def tup(key, default):
        v = g(key)
        if v is None:
            return default
        return tuple(v) if isinstance(v, list) else (v,) * len(default)

    nat = 2   # itemp + isalt (mod_param.F NAT); NT grows with tnu2 list
    vert = C.VerticalCoordConfig(
        N=int(g("N", 16)),
        Vtransform=int(_first(g("Vtransform"), 2)),
        Vstretching=int(_first(g("Vstretching"), 4)),
        theta_s=float(_first(g("THETA_S"), 3.0)),
        theta_b=float(_first(g("THETA_B"), 0.0)),
        Tcline=float(_first(g("TCLINE"), 25.0)))
    eos = C.EOSConfig(
        R0=float(_first(g("R0"), 1027.0)),
        T0=float(_first(g("T0"), 14.0)),
        S0=float(_first(g("S0"), 35.0)),
        Tcoef=float(_first(g("TCOEF"), 1.7e-4)),
        Scoef=float(_first(g("SCOEF"), 0.0)))
    mixing = C.MixingConfig(
        visc2=float(_first(g("VISC2"), 0.0)),
        visc4=float(_first(g("VISC4"), 0.0)),
        tnu2=tup("TNU2", (0.0, 0.0)),
        tnu4=tup("TNU4", (0.0, 0.0)),
        akv_bak=float(_first(g("AKV_BAK"), 1.0e-5)),
        akt_bak=tup("AKT_BAK", (1.0e-6, 1.0e-6)),
        akk_bak=float(_first(g("AKK_BAK"), 5.0e-6)),
        akp_bak=float(_first(g("AKP_BAK"), 5.0e-6)),
        gls_p=float(_first(g("GLS_P"), 3.0)),
        gls_m=float(_first(g("GLS_M"), 1.5)),
        gls_n=float(_first(g("GLS_N"), -1.0)),
        gls_cmu0=float(_first(g("GLS_CMU0"), 0.5477)),
        gls_c1=float(_first(g("GLS_C1"), 1.44)),
        gls_c2=float(_first(g("GLS_C2"), 1.92)),
        gls_c3m=float(_first(g("GLS_C3M"), -0.4)),
        gls_c3p=float(_first(g("GLS_C3P"), 1.0)),
        gls_sigk=float(_first(g("GLS_SIGK"), 1.0)),
        gls_sigp=float(_first(g("GLS_SIGP"), 1.3)),
        gls_kmin=float(_first(g("GLS_Kmin"), 7.6e-6)),
        gls_pmin=float(_first(g("GLS_Pmin"), 1.0e-12)),
        gls_Zos=float(_first(g("ZOS"), 0.02)),
        jwtype=int(_first(g("WTYPE"), 1)))
    rdrg2 = float(_first(g("RDRG2"), 3.0e-3))
    rdrg = float(_first(g("RDRG"), 3.0e-4))
    drag = C.BottomDragConfig(
        rdrg=rdrg, rdrg2=rdrg2,
        Zob=float(_first(g("Zob"), 0.02)))
    volcons = tuple(e for e in ("west", "south", "east", "north")
                    if params.get(f"VolCons({e})") is True)
    bc = C.BoundaryConfig(
        zeta=_lbc(params, "LBC(isFsur)"),
        ubar=_lbc(params, "LBC(isUbar)"),
        vbar=_lbc(params, "LBC(isVbar)"),
        u=_lbc(params, "LBC(isUvel)"),
        v=_lbc(params, "LBC(isVvel)"),
        t=_lbc(params, "LBC(isTvar)"),
        tke=_lbc(params, "LBC(isMtke)"),
        volcons=volcons)

    def _days_to_rate(v):
        """inp_par.F:697-717: deck values in DAYS -> 1/s (0 stays 0)."""
        d = float(v)
        return 1.0 / (d * 86400.0) if d > 0.0 else 0.0

    def _ltup(key):
        v = g(key)
        if v is None:
            return ()
        return tuple(bool(x) for x in (v if isinstance(v, list)
                                       else [v]))

    tn = g("TNUDG", 0.0)
    nudg = C.NudgingConfig(
        znudg=_days_to_rate(_first(g("ZNUDG"), 0.0)),
        m2nudg=_days_to_rate(_first(g("M2NUDG"), 0.0)),
        m3nudg=_days_to_rate(_first(g("M3NUDG"), 0.0)),
        tnudg=tuple(_days_to_rate(x) for x in
                    (tn if isinstance(tn, list) else [tn])),
        obcfac=float(_first(g("OBCFAC"), 0.0)),
        lnudge_m2clm=bool(_first(g("LnudgeM2CLM"), False)),
        lnudge_m3clm=bool(_first(g("LnudgeM3CLM"), False)),
        lnudge_tclm=_ltup("LnudgeTCLM"),
        luv_sponge=bool(_first(g("LuvSponge"), False)),
        ltracer_sponge=_ltup("LtracerSponge"))

    cfg = C.ModelConfig(
        Lm=int(g("Lm", 41)), Mm=int(g("Mm", 80)),
        NT=max(nat, len(mixing.tnu2)), NAT=nat,
        nudg=nudg,
        dt=float(_first(g("DT"), 300.0)),
        ndtfast=int(_first(g("NDTFAST"), 30)),
        vert=vert, eos=eos, mixing=mixing, drag=drag, bc=bc,
        rho0=float(_first(g("RHO0"), 1025.0)),
        gamma2=float(_first(g("GAMMA2"), 1.0)),
        Dcrit=float(_first(g("DCRIT"), 0.10)),
        blk_zw=float(_first(g("BLK_ZW"), 10.0)),
        blk_zt=float(_first(g("BLK_ZT"), 10.0)),
        blk_zq=float(_first(g("BLK_ZQ"), 10.0)),
        levsfrc=int(_first(g("LEVSFRC"), 1)),
        hadv=_adv_scheme(params, "Hadvection", C.UPSTREAM3),
        vadv=_adv_scheme(params, "Vadvection", C.CENTERED4),
        hadv_t=_adv_registry(params, "Hadvection", C.UPSTREAM3),
        vadv_t=_adv_registry(params, "Vadvection", C.CENTERED4))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg

