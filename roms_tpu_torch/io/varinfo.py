"""Output field metadata registry (a copy of roms_tpu/io/varinfo.py).

The native equivalent of the reference's ROMS/External/varinfo.yaml
(7951 lines, 701 variables) + mod_ncparam: every exportable field
carries its I/O name, long name, units and C-grid location.  Locations:
r2/u2/v2 (2-D rho/u/v), r3/u3/v3 (3-D at rho levels), w3 (3-D at w
interfaces), b3 (sediment bed layers), nul (non-gridded).

The registry below covers the dynamical core, forcing/flux fields,
turbulence, BBL, ice, sediment, and every biology tracer of the
implemented ecosystem models (the port writes the subset its model
carries).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class VarInfo:
    name: str
    long_name: str
    units: str
    location: str
    time: bool = True
    standard_name: str = ""
    field: str = ""
    index_code: str = ""
    scale: float = 1.0
    add_offset: float = 0.0


def _v(name, long_name, units, loc, **kw):
    return VarInfo(name, long_name, units, loc, **kw)


# Keyed by State attribute (or derived-field key).
REGISTRY = {
    # ---- prognostic state (varinfo.yaml "State Variables") -------------
    "zeta": _v("zeta", "free-surface", "meter", "r2",
               standard_name="sea_surface_height_above_geopotential_datum",
               index_code="idFsur"),
    "ubar": _v("ubar", "vertically integrated u-momentum component",
               "meter second-1", "u2", index_code="idUbar"),
    "vbar": _v("vbar", "vertically integrated v-momentum component",
               "meter second-1", "v2", index_code="idVbar"),
    "u": _v("u", "u-momentum component", "meter second-1", "u3",
            standard_name="sea_water_x_velocity", index_code="idUvel"),
    "v": _v("v", "v-momentum component", "meter second-1", "v3",
            standard_name="sea_water_y_velocity", index_code="idVvel"),
    "temp": _v("temp", "potential temperature", "Celsius", "r3",
               standard_name="sea_water_potential_temperature",
               index_code="idTvar"),
    "salt": _v("salt", "salinity", "", "r3",
               standard_name="sea_water_practical_salinity",
               index_code="idTvar"),
    "rho": _v("rho", "density anomaly", "kilogram meter-3", "r3",
              index_code="idDano"),
    "w": _v("w", "vertical momentum component", "meter second-1", "w3",
            index_code="idWvel"),
    "omega": _v("omega", "S-coordinate vertical momentum component",
                "meter3 second-1", "w3", index_code="idOvel"),
    # quicksave (QCK) surface slices (wrt_quick.F surface switches)
    "temp_sur": _v("temp_sur", "surface temperature", "Celsius", "r2"),
    "salt_sur": _v("salt_sur", "surface salinity", "", "r2"),
    "u_sur": _v("u_sur", "surface u-momentum", "meter second-1", "u2"),
    "v_sur": _v("v_sur", "surface v-momentum", "meter second-1", "v2"),

    # ---- turbulence closure fields -------------------------------------
    "tke": _v("tke", "turbulent kinetic energy", "meter2 second-2", "w3",
              index_code="idMtke"),
    "gls": _v("gls", "generic length-scale", "meter3 second-2", "w3",
              index_code="idMtls"),
    "AKv": _v("AKv", "vertical viscosity coefficient", "meter2 second-1",
              "w3", index_code="idVvis"),
    "AKt": _v("AKt", "temperature vertical diffusion coefficient",
              "meter2 second-1", "w3", index_code="idTdif"),
    "AKs": _v("AKs", "salinity vertical diffusion coefficient",
              "meter2 second-1", "w3", index_code="idSdif"),
    "AKk": _v("AKk", "turbulent kinetic energy vertical diffusion "
              "coefficient", "meter2 second-1", "w3"),
    "Lscale": _v("Lscale", "turbulence length scale", "meter", "w3"),
    "hsbl": _v("Hsbl", "depth of oceanic surface boundary layer",
               "meter", "r2", index_code="idHsbl"),
    "hbbl": _v("Hbbl", "depth of oceanic bottom boundary layer",
               "meter", "r2", index_code="idHbbl"),

    # ---- surface/bottom fluxes and atmosphere --------------------------
    "sustr": _v("sustr", "surface u-momentum stress", "newton meter-2",
                "u2", index_code="idUsms"),
    "svstr": _v("svstr", "surface v-momentum stress", "newton meter-2",
                "v2", index_code="idVsms"),
    "bustr": _v("bustr", "bottom u-momentum stress", "newton meter-2",
                "u2", index_code="idUbms"),
    "bvstr": _v("bvstr", "bottom v-momentum stress", "newton meter-2",
                "v2", index_code="idVbms"),
    "shflux": _v("shflux", "surface net heat flux", "watt meter-2",
                 "r2", index_code="idTsur"),
    "ssflux": _v("ssflux", "surface net salt flux, (E-P)*SALT",
                 "meter second-1", "r2"),
    "swrad": _v("swrad", "solar shortwave radiation flux",
                "watt meter-2", "r2", index_code="idSrad"),
    "lwrad": _v("lwrad", "net longwave radiation flux", "watt meter-2",
                "r2", index_code="idLrad"),
    "latent": _v("latent", "net latent heat flux", "watt meter-2", "r2",
                 index_code="idLhea"),
    "sensible": _v("sensible", "net sensible heat flux", "watt meter-2",
                   "r2", index_code="idShea"),
    "EminusP": _v("EminusP", "bulk flux surface net freshwater flux",
                  "meter second-1", "r2", index_code="idEmPf"),
    "evaporation": _v("evaporation", "evaporation rate",
                      "kilogram meter-2 second-1", "r2"),
    "rain": _v("rain", "rain fall rate", "kilogram meter-2 second-1",
               "r2", index_code="idrain"),
    "Pair": _v("Pair", "surface air pressure", "millibar", "r2",
               index_code="idPair"),
    "Tair": _v("Tair", "surface air temperature", "Celsius", "r2",
               index_code="idTair"),
    "Uwind": _v("Uwind", "surface u-wind component", "meter second-1",
                "r2", index_code="idUair"),
    "Vwind": _v("Vwind", "surface v-wind component", "meter second-1",
                "r2", index_code="idVair"),

    # ---- static grid fields --------------------------------------------
    "h": _v("h", "bathymetry at RHO-points", "meter", "r2", time=False),
    "f": _v("f", "Coriolis parameter at RHO-points", "second-1", "r2",
            time=False),
    "pm": _v("pm", "curvilinear coordinate metric in XI", "meter-1",
             "r2", time=False),
    "pn": _v("pn", "curvilinear coordinate metric in ETA", "meter-1",
             "r2", time=False),
    "lon_rho": _v("lon_rho", "longitude of RHO-points", "degree_east",
                  "r2", time=False),
    "lat_rho": _v("lat_rho", "latitude of RHO-points", "degree_north",
                  "r2", time=False),
    "angle": _v("angle", "angle between XI-axis and EAST", "radians",
                "r2", time=False),
    "mask_rho": _v("mask_rho", "mask on RHO-points", "", "r2",
                   time=False),

    # ---- NPZD-family biology tracers (npzd_*_var.h) ---------------------
    "NO3": _v("NO3", "nitrate concentration", "millimole_nitrogen "
              "meter-3", "r3", index_code="idTvar"),
    "NH4": _v("NH4", "ammonium concentration", "millimole_nitrogen "
              "meter-3", "r3", index_code="idTvar"),
    "phytoplankton": _v("phytoplankton", "phytoplankton concentration",
                        "millimole_nitrogen meter-3", "r3"),
    "zooplankton": _v("zooplankton", "zooplankton concentration",
                      "millimole_nitrogen meter-3", "r3"),
    "detritus": _v("detritus", "detritus concentration",
                   "millimole_nitrogen meter-3", "r3"),
    "SdetritusN": _v("SdetritusN", "small detritus nitrogen "
                     "concentration", "millimole_nitrogen meter-3", "r3"),
    "LdetritusN": _v("LdetritusN", "large detritus nitrogen "
                     "concentration", "millimole_nitrogen meter-3", "r3"),
    "chlorophyll": _v("chlorophyll", "chlorophyll concentration",
                      "milligrams_chlorophyll meter-3", "r3"),
    "oxygen": _v("oxygen", "dissolved oxygen concentration",
                 "millimole_oxygen meter-3", "r3"),
    "iron": _v("iron", "available dissolved iron concentration",
               "millimole_iron meter-3", "r3"),
    "PO4": _v("PO4", "phosphate concentration",
              "millimole_phosphorus meter-3", "r3"),
    "TIC": _v("TIC", "total inorganic carbon",
              "millimole_carbon meter-3", "r3"),
    "alkalinity": _v("alkalinity", "total alkalinity",
                     "milliequivalents meter-3", "r3"),

    # ---- sediment (sediment_var.h) --------------------------------------
    "sand_01": _v("sand_01", "suspended noncohesive sediment, class 01",
                  "kilogram meter-3", "r3"),
    "mud_01": _v("mud_01", "suspended cohesive sediment, class 01",
                 "kilogram meter-3", "r3"),
    "bed_thickness": _v("bed_thickness", "sediment bed layer thickness",
                        "meter", "b3"),
    "bed_age": _v("bed_age", "sediment bed layer age", "seconds", "b3"),
    "bed_porosity": _v("bed_porosity", "sediment bed layer porosity",
                       "", "b3"),
    "bedldu_01": _v("bedldu_01", "bed load flux of sand in "
                    "XI-direction, class 01", "kilogram meter-1 "
                    "second-1", "u2"),
    "bedldv_01": _v("bedldv_01", "bed load flux of sand in "
                    "ETA-direction, class 01", "kilogram meter-1 "
                    "second-1", "v2"),

    # ---- sea ice (ice_var.h analogs) ------------------------------------
    "ice_a": _v("aice", "fraction of cell covered by ice", "", "r2"),
    "ice_h": _v("hice", "average ice thickness in cell", "meter", "r2"),
    "ice_u": _v("uice", "u-component of ice velocity",
                "meter second-1", "u2"),
    "ice_v": _v("vice", "v-component of ice velocity",
                "meter second-1", "v2"),
    "ice_t": _v("tice", "interior ice temperature", "Celsius", "r2"),

    # ---- WEC / waves -----------------------------------------------------
    "Hwave": _v("Hwave", "wind-induced significant wave height",
                "meter", "r2", index_code="idWamp"),
    "Dwave": _v("Dwave", "wind-induced wave direction", "radians", "r2",
                index_code="idWdir"),
    "Lwave": _v("Lwave", "wind-induced mean wavelength", "meter", "r2",
                index_code="idWlen"),
    "ubar_stokes": _v("ubar_stokes", "vertically integrated u-Stokes "
                      "drift", "meter second-1", "u2"),
    "vbar_stokes": _v("vbar_stokes", "vertically integrated v-Stokes "
                      "drift", "meter second-1", "v2"),
    "u_stokes": _v("u_stokes", "u-Stokes drift velocity",
                   "meter second-1", "u3"),
    "v_stokes": _v("v_stokes", "v-Stokes drift velocity",
                   "meter second-1", "v3"),
}

# DIAGNOSTICS_TS budget terms (set_diags.F / DIA stream)
for _trc in ("temp", "salt"):
    _units = "Celsius meter second-1" if _trc == "temp" \
        else "meter second-1"
    for _term, _desc in (("rate", "time rate of change"),
                         ("hadv", "horizontal advection"),
                         ("vadv", "vertical advection"),
                         ("vdif", "vertical diffusion"),
                         ("forc", "surface and volume forcing"),
                         ("nudg", "climatology nudging")):
        REGISTRY[f"{_trc}_{_term}"] = _v(
            f"{_trc}_{_term}", f"{_trc} {_desc}", _units, "r3")

# DIAGNOSTICS_UV budget terms (set_diags.F / DIA stream, u/v budgets)
for _mom, _loc in (("u", "u3"), ("v", "v3")):
    for _term, _desc in (("rate", "time rate of change"),
                         ("hadv", "horizontal advection"),
                         ("vadv", "vertical advection"),
                         ("cor", "Coriolis"),
                         ("prsgrd", "pressure gradient"),
                         ("hvisc", "horizontal viscosity"),
                         ("vvisc", "vertical viscosity"),
                         ("pre", "predictor-step contribution"),
                         ("cpl", "barotropic coupling adjustment")):
        REGISTRY[f"{_mom}_{_term}"] = _v(
            f"{_mom}_{_term}", f"{_mom}-momentum {_desc}",
            "meter second-2", _loc)

TRACER_NAMES = ("temp", "salt")


def varinfo_for(key: str) -> VarInfo:
    """Registry entry for `key`, synthesizing one for the fields the
    static table cannot enumerate: the _sur slices and application
    tracers named by cfg.tracer_names.  The synthesized location code
    drives the writer's dimension layout exactly like a varinfo.yaml
    entry would."""
    if key in REGISTRY:
        return REGISTRY[key]
    if key.endswith("_sur"):
        base = varinfo_for(key[:-4])
        loc = {"r3": "r2", "u3": "u2", "v3": "v2"}.get(base.location,
                                                       "r2")
        return _v(key, f"surface {base.long_name}", base.units, loc)
    # application tracer (inert dyes and the like)
    return _v(key, key, "", "r3", index_code="idTvar")


def dims_for(location: str, N: int):
    return {
        "r2": ("eta_rho", "xi_rho"),
        "u2": ("eta_u", "xi_u"),
        "v2": ("eta_v", "xi_v"),
        "r3": ("s_rho", "eta_rho", "xi_rho"),
        "u3": ("s_rho", "eta_u", "xi_u"),
        "v3": ("s_rho", "eta_v", "xi_v"),
        "w3": ("s_w", "eta_rho", "xi_rho"),
        "b3": ("Nbed", "eta_rho", "xi_rho"),
    }[location]
