"""Model configuration.

The reference model configures itself through ~700 compile-time CPP options
(ROMS/Include/cppdefs.h) plus runtime `roms_*.in` keyword files parsed by
ROMS/Utility/inp_par.F.  Here the two tiers collapse into one frozen, hashable
dataclass tree: passing a `ModelConfig` as a static argument to `jax.jit`
specializes the compiled program exactly like CPP specialized the Fortran —
branches on config fields are resolved at trace time, so the XLA program
contains only the selected schemes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Lateral boundary condition taxonomy (mod_param.F:357-373).
# ---------------------------------------------------------------------------

PERIODIC = "periodic"
CLOSED = "closed"
GRADIENT = "gradient"
CLAMPED = "clamped"
RADIATION = "radiation"
FLATHER = "flather"          # ubar/vbar only
SHCHEPETKIN = "shchepetkin"  # ubar/vbar only (Maison et al. 2010)
CHAPMAN_IMPLICIT = "chapman_implicit"  # zeta only
CHAPMAN_EXPLICIT = "chapman_explicit"  # zeta only
REDUCED = "reduced"

WEST, SOUTH, EAST, NORTH = "west", "south", "east", "north"


@dataclass(frozen=True)
class LBC:
    """Per-edge boundary condition for one state variable.

    Mirrors the reference's T_LBC switch structure (mod_param.F:357-373) and
    the `LBC(...) == Per Clo Per Clo` input syntax (roms_upwelling.in:184-199,
    order West South East North).
    """

    west: str = CLOSED
    south: str = CLOSED
    east: str = CLOSED
    north: str = CLOSED
    # Edges where radiation is combined with nudging toward external
    # data (the deck's "RadNud" keyword; T_LBC%nudging in
    # mod_param.F:357-373).  Taus come from NudgingConfig (FSobc/M2obc/
    # M3obc/Tobc in/out, inp_par.F:726-753).
    nudge: Tuple[str, ...] = ()

    @classmethod
    def same(cls, kind: str) -> "LBC":
        return cls(west=kind, south=kind, east=kind, north=kind)

    @classmethod
    def ew_periodic(cls, ns: str = CLOSED) -> "LBC":
        return cls(west=PERIODIC, east=PERIODIC, south=ns, north=ns)

    @classmethod
    def ns_periodic(cls, ew: str = CLOSED) -> "LBC":
        return cls(west=ew, east=ew, south=PERIODIC, north=PERIODIC)


@dataclass(frozen=True)
class BoundaryConfig:
    """Boundary selections for every prognostic variable family."""

    zeta: LBC = field(default_factory=LBC)
    ubar: LBC = field(default_factory=LBC)
    vbar: LBC = field(default_factory=LBC)
    u: LBC = field(default_factory=LBC)
    v: LBC = field(default_factory=LBC)
    t: LBC = field(default_factory=LBC)   # all tracers share one spec for now
    tke: LBC = field(default_factory=LBC)
    # Enforce integral volume conservation across these open edges
    # (VolCons switches of obc_volcons.F)
    volcons: Tuple[str, ...] = ()

    @property
    def ew_periodic(self) -> bool:
        return self.zeta.west == PERIODIC

    @property
    def ns_periodic(self) -> bool:
        return self.zeta.south == PERIODIC

    @classmethod
    def uniform(cls, lbc: LBC) -> "BoundaryConfig":
        return cls(zeta=lbc, ubar=lbc, vbar=lbc, u=lbc, v=lbc, t=lbc, tke=lbc)


# ---------------------------------------------------------------------------
# Scheme selections (replacing CPP options).
# ---------------------------------------------------------------------------

# Tracer advection schemes (ROMS/Utility/tadv.F:146-180).
UPSTREAM3 = "upstream3"
CENTERED2 = "centered2"
CENTERED4 = "centered4"
AKIMA4 = "akima4"
SPLINES = "splines"
SPLIT_U3 = "split_u3"
HSIMT = "hsimt"
MPDATA = "mpdata"
SPLIT_U3 = "split_u3"
MPDATA = "mpdata"
SPLIT_U3 = "split_u3"


@dataclass(frozen=True)
class VerticalCoordConfig:
    """Terrain-following coordinate (ROMS/Utility/set_scoord.F)."""

    N: int = 16
    Vtransform: int = 2        # roms_upwelling.in:415
    Vstretching: int = 4       # roms_upwelling.in:416
    theta_s: float = 3.0       # surface stretching
    theta_b: float = 0.0       # bottom stretching
    Tcline: float = 25.0       # critical depth hc (m)


@dataclass(frozen=True)
class EOSConfig:
    """Equation of state (ROMS/Nonlinear/rho_eos.F).

    linear=True follows rho_eos.F:694-723:
        rho = R0 - R0*Tcoef*(T-T0) + R0*Scoef*(S-S0) - 1000
    linear=False selects the Jackett & McDougall (1995) polynomial
    (rho_eos.F:12-37).
    """

    linear: bool = True
    R0: float = 1027.0
    T0: float = 14.0
    S0: float = 35.0
    Tcoef: float = 1.7e-4
    Scoef: float = 0.0


@dataclass(frozen=True)
class MixingConfig:
    # Horizontal harmonic viscosity/diffusion (m2/s)
    visc2: float = 0.0              # VISC2 (roms_upwelling.in:316)
    tnu2: Tuple[float, ...] = (0.0, 0.0)   # TNU2 per tracer
    # Horizontal biharmonic coefficients (m4/s); the kernels use their
    # square roots, as in inp_par.F (visc4=sqrt(VISC4))
    visc4: float = 0.0
    tnu4: Tuple[float, ...] = (0.0, 0.0)
    # Rotate harmonic tracer diffusion along geopotentials (MIX_GEO_TS)
    mix_geo_ts: bool = False
    # Rotate along isopycnals instead (MIX_ISO_TS, t3dmix2_iso.h)
    mix_iso_ts: bool = False
    # Rotate harmonic momentum viscosity along geopotentials
    # (MIX_GEO_UV, uv3dmix2_geo.h)
    mix_geo_uv: bool = False
    # Smagorinsky deformation-dependent horizontal mixing
    # (UV_SMAGORINSKY / TS_SMAGORINSKY, hmixing.F)
    smagorinsky: bool = False
    smagor_coef: float = 0.1
    # Vertical background mixing
    akv_bak: float = 1.0e-5         # AKV_BAK
    akt_bak: Tuple[float, ...] = (1.0e-6, 1.0e-6)  # AKT_BAK per tracer
    # Vertical closure: 'ana' (analytic profile), 'constant', 'gls', 'lmd'
    vmix: str = "constant"
    # Penetrative shortwave heating (SOLAR_SOURCE)
    solar_source: bool = False
    # Bottom boundary layer KPP (LMD_BKPP), used with vmix == 'lmd'
    bkpp: bool = False
    # Jerlov water type 1-5 for shortwave extinction (WTYPE,
    # lmd_swfrac.F Jwtype)
    jwtype: int = 1
    # Double-diffusive interior mixing (LMD_DDMIX, lmd_vmix.F:363-429)
    ddmix: bool = False
    # GLS parameters (roms_*.in GLS_*), used when vmix == 'gls'
    gls_p: float = 3.0
    gls_m: float = 1.5
    gls_n: float = -1.0
    gls_cmu0: float = 0.5477
    gls_c1: float = 1.44
    gls_c2: float = 1.92
    gls_c3m: float = -0.4
    gls_c3p: float = 1.0
    gls_sigk: float = 1.0
    gls_sigp: float = 1.3
    gls_kmin: float = 7.6e-6
    gls_pmin: float = 1.0e-12
    gls_stab: str = "canuto_a"   # 'canuto_a' | 'kantha_clayson'
    gls_Zos: float = 0.02        # surface roughness (m), Zos in roms_*.in
    akk_bak: float = 5.0e-6
    akp_bak: float = 5.0e-6
    # Use parabolic-spline reconstruction for implicit vertical solves
    # (SPLINES_VDIFF / SPLINES_VVISC in upwelling.h:21-22).
    splines_vdiff: bool = True
    # Epineutral (MIX_ISO_TS) weak-stratification limiter branch
    # (t3dmix2_iso.h:188-324): 'eps' floors the per-layer density jump
    # at 0.5 kg/m3 (the reference default — rotation degrades to
    # s-surfaces in weak stratification), 'max_slope' keeps the small
    # 1e-14 floor but caps the slope (TS_MIX_MAX_SLOPE), 'min_strat'
    # enforces d(rho)/dz >= 0.1 (TS_MIX_MIN_STRAT).
    ts_mix_limit: str = "eps"
    splines_vvisc: bool = True


@dataclass(frozen=True)
class NudgingConfig:
    """Nudging inverse time scales and switches (read_phypar.F TNUDG/
    ZNUDG/M2NUDG/M3NUDG/OBCFAC + Lnudge*CLM + sponge logicals).

    All rates are 1/s — the deck values in DAYS are converted by the
    parser exactly as inp_par.F:697-717 does (0 days -> rate 0).  The
    radiation-nudging boundary taus follow inp_par.F:726-753:
    outflow tau = rate, inflow tau = obcfac * rate, active only on
    edges listed in the corresponding LBC.nudge.
    """

    znudg: float = 0.0                   # free surface (FSobc)
    m2nudg: float = 0.0                  # 2D momentum (M2obc)
    m3nudg: float = 0.0                  # 3D momentum (M3obc)
    tnudg: Tuple[float, ...] = ()        # per-tracer (Tobc)
    obcfac: float = 0.0                  # inflow/outflow asymmetry
    # climatology nudging switches (read_phypar.F Lnudge*CLM)
    lnudge_m2clm: bool = False
    lnudge_m3clm: bool = False
    lnudge_tclm: Tuple[bool, ...] = ()
    # sponge-layer switches (LuvSponge / LtracerSponge)
    luv_sponge: bool = False
    ltracer_sponge: Tuple[bool, ...] = ()

    def tobc(self, itrc: int) -> Tuple[float, float]:
        """(tau_in, tau_out) for tracer itrc radiation nudging."""
        rate = self.tnudg[itrc] if itrc < len(self.tnudg) else (
            self.tnudg[-1] if self.tnudg else 0.0)
        return self.obcfac * rate, rate


@dataclass(frozen=True)
class BottomDragConfig:
    """UV_LDRAG/UV_QDRAG/UV_LOGDRAG selection (set_vbc.F)."""

    kind: str = "linear"      # 'linear' | 'quadratic' | 'log' | 'none'
    rdrg: float = 3.0e-4      # m/s
    rdrg2: float = 3.0e-3     # nondimensional
    Zob: float = 0.02         # m
    Cdb_min: float = 1.0e-6
    Cdb_max: float = 0.5


@dataclass(frozen=True)
class ModelConfig:
    """Master configuration — static under jit."""

    # Grid dimensions: interior RHO-points (mod_param.F Lm/Mm/N).
    Lm: int = 41
    Mm: int = 80

    # Number of active + passive tracers (itemp, isalt, ...).
    NT: int = 2
    NAT: int = 2

    # Time stepping (roms_upwelling.in:231-233).
    dt: float = 300.0
    ndtfast: int = 30

    vert: VerticalCoordConfig = field(default_factory=VerticalCoordConfig)
    eos: EOSConfig = field(default_factory=EOSConfig)
    mixing: MixingConfig = field(default_factory=MixingConfig)
    drag: BottomDragConfig = field(default_factory=BottomDragConfig)
    bc: BoundaryConfig = field(default_factory=BoundaryConfig)
    nudg: NudgingConfig = field(default_factory=NudgingConfig)

    rho0: float = 1025.0
    g: float = 9.81           # gravity; nondimensional apps override (SOLITON)
    # Wetting and drying (WET_DRY): cells with depth < Dcrit are masked
    wetdry: bool = False
    Dcrit: float = 0.10       # m
    gamma2: float = 1.0       # slipperiness (free slip = 1)

    # Tracer advection scheme selection (Hadvection/Vadvection in
    # roms_*.in; tadv.F:146-180).  hadv/vadv are the defaults for every
    # tracer; hadv_t/vadv_t give the per-tracer registry — a tuple of
    # scheme names indexed by tracer (entries beyond its length fall
    # back to the default), so e.g. MPDATA-for-bio + U3-for-temp is one
    # config.  Being static config, mixed schemes specialize the trace
    # exactly like the reference's per-tracer IF-dispatch.
    hadv: str = UPSTREAM3
    vadv: str = CENTERED4     # reference default for UPWELLING is CENTERED4
    # (actually SPLINES via ana config; see apps)
    hadv_t: Optional[Tuple[str, ...]] = None
    vadv_t: Optional[Tuple[str, ...]] = None

    # Adaptive Courant-limited implicit vertical advection
    # (OMEGA_IMPLICIT, omega.F:184-345 + step3d_*.F solves)
    omega_implicit: bool = False

    # Pressure-gradient scheme: 'djs' (splines density Jacobian,
    # DJ_GRADPS default), 'sj'/'sj_wj' (standard/weighted Jacobian,
    # prsgrd31), or 'fv' (finite-volume Lin 97, prsgrd40).
    prsgrd: str = "djs"

    # Barotropic engine: 'lf_am3' (the reference's wired default,
    # step2d_LF_AM3.h) or 'fb' (generalized FB AB3-AM4,
    # step2d_FB.h — present but unwired in the reference; wired here
    # as the modern single-stage scheme).
    step2d: str = "lf_am3"

    # COARE bulk-flux measurement heights (m): wind / air temperature
    # / humidity (BLK_ZW/BLK_ZT/BLK_ZQ, roms_*.in; mod_scalars.F
    # blk_ZW defaults).  Consumed by core.bulk_flux and
    # ops.pallas_bulk.
    blk_zw: float = 10.0
    blk_zt: float = 10.0
    blk_zq: float = 10.0

    # Scalar self-attraction-and-loading tide factor beta:
    # zeta_SAL = beta * zeta, weakening the surface pressure gradient
    # to g*(1-beta)*grad(zeta) (Accad & Pekeris 1978 scalar
    # approximation of the reference's SAL loading tide).
    sal_scalar: float = 0.0

    # Momentum advection: 'up3' (default UV_ADV), 'c2', 'c4', or None.
    uv_hadv: str = "up3"
    uv_vadv: str = "c4_sw"    # 4th-order stencil with 4th-order W (rhs3d.F default)
    uv_cor: bool = True
    uv_adv: bool = True
    curvgrid: bool = False
    # BODYFORCE: deposit wind stress over levels levsfrc..N as a body
    # force instead of a surface flux (rhs3d.F BODYFORCE; LEVSFRC)
    bodyforce: bool = False
    levsfrc: int = 1

    # I/O names of the tracers beyond temp/salt (mod_ncparam idTvar
    # naming; e.g. Fennel sets ("NO3","NH4","chlorophyll",...)).
    # Unnamed extra tracers fall back to "tracerNN".
    tracer_names: Optional[Tuple[str, ...]] = None

    # Solver precision of state arrays ('float32' or 'float64').
    dtype: str = "float32"

    # Number of fast steps actually taken (nfast) is derived from the filter
    # weights at setup; see roms_tpu.core.weights.

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def tracer_hadv(self, itrc: int) -> str:
        """Per-tracer horizontal scheme (tadv.F registry semantics)."""
        if self.hadv_t is not None and itrc < len(self.hadv_t):
            return self.hadv_t[itrc]
        return self.hadv

    def tracer_vadv(self, itrc: int) -> str:
        if self.vadv_t is not None and itrc < len(self.vadv_t):
            return self.vadv_t[itrc]
        return self.vadv

    @property
    def L(self) -> int:
        return self.Lm + 1

    @property
    def M(self) -> int:
        return self.Mm + 1

    @property
    def shape2d(self) -> Tuple[int, int]:
        """(eta, xi) array shape including the boundary ring."""
        return (self.Mm + 2, self.Lm + 2)

    @property
    def N(self) -> int:
        return self.vert.N
