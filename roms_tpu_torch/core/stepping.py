"""Baroclinic time-step orchestrator (port of roms_tpu/core/stepping.py;
main3d.F:216-1130).

One `step` = prep (mass fluxes, EOS, forcing, bottom drag, vertical
mixing, omega), the predictor stage (pre_step3d, pressure gradient,
RHS, horizontal mixing), the fast barotropic loop, new depths, then the
3D correctors.  The port carries the branches of the closed-basin
DOUBLE_GYRE class, the EW-periodic UPWELLING channel with the analytic,
GLS or MY2.5 vertical closure, the BENCHMARK full physics (JM95, COARE
bulk fluxes that take the ocean surface state, LMD-KPP with the solar
source and nonlocal transport, MIX_GEO_TS, quadratic drag), NS-periodic
and doubly periodic grids, logarithmic drag, and LMD's bottom boundary
layer (LMD_BKPP) and double diffusion (LMD_DDMIX) on the whole-array
LMD route; every other hook raises NotImplementedError naming the
ROADMAP Queue 1 item that brings it.

Kernels: `Model(..., use_kernels=True)` (the default) sends the kernel
entry points through their wrappers, which launch the CUDA kernels on
CUDA tensors and take the plain PyTorch versions on CPU tensors.  Each
kernel runs where its `covers(cfg)` holds, exactly where roms_tpu runs
its Pallas kernel, and the step takes the core modules' own code
elsewhere (on NS-periodic grids, for example, core/advection.py and
core/rhs3d.py, which keep roms_tpu's ring rows where the tadv and rhs3d
kernels zero them).
`use_kernels=False` runs every kernel's plain version on the same route
(the bulk forcing included) and is the only way to run them on the card.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

import torch

from ..config import ModelConfig
from ..grid.depth import set_depth, set_massflux
from ..grid.grid import Grid
from ..ops import flux as flux_op, prep as prep_op
from ..ops import prsgrd as prsgrd_op, stencil as st
from ..ops.rho import rho_eos_plain
from . import gls as gls_mod, hmix, lmd as lmd_mod, my25 as my25_mod
from . import omega as omega_mod, prsgrd, rhs3d, set_vbc
from .pre_step3d import pre_step3d
from .rho_eos import rho_eos
from .state import State
from .step2d import make_fast_loop
from .step3d_t import step3d_t
from .step3d_uv import step3d_uv
from .weights import power_law_weights

_LATER = {
    "obc_fn": "open boundaries (ROADMAP Queue 1 item 6)",
    "clm_fn": "climatology nudging (ROADMAP Queue 1 item 6)",
    "bio_fn": "biology (ROADMAP Queue 1 item 8)",
    "sources": "point sources (ROADMAP Queue 1 item 6)",
    "sed_fn": "sediment (ROADMAP Queue 1 item 8)",
    "bbl_fn": "bottom boundary layer (ROADMAP Queue 1 item 8)",
    "eq_tide_fn": "equilibrium tide (ROADMAP Queue 1 item 6)",
    "ice_fn": "sea ice (ROADMAP Queue 1 item 8)",
    "wec_fn": "wave-current coupling (ROADMAP Queue 1 item 8)",
    "pair_fn": "air pressure (ROADMAP Queue 1 item 6)",
    "flux_corr_fn": "surface flux corrections (ROADMAP Queue 1 item 8)",
}


def make_bvf_mix(cfg: ModelConfig, bvf_nu0: float = 1.0e-7,
                 bvf_nu0c: float = 1.0, bvf_numin: float = 3.0e-5,
                 bvf_numax: float = 4.0e-4):
    """Brunt-Vaisala-frequency mixing (bvf_mix.F:88-115,
    mod_scalars.F:1883-1886 defaults):

        bvf < 0  ->  convective value bvf_nu0c (1 m2/s)
        bvf > 0  ->  clip(bvf_nu0 / sqrt(bvf), numin, numax)

    computed diagnostically from the time-n stratification with the
    plain EOS, as roms_tpu computes it with its jnp EOS."""
    def vmix(state, grid, z_w):
        bvf = rho_eos_plain(cfg, state.t, state.z_r, state.Hz, z_w)[4]
        cff = bvf_nu0 / torch.sqrt(torch.clamp(bvf, min=1.0e-20))
        stable = torch.clamp(cff, bvf_numin, bvf_numax)
        Ak_i = torch.where(bvf < 0.0, torch.full_like(bvf, bvf_nu0c),
                           torch.where(bvf == 0.0, torch.full_like(
                               bvf, cfg.mixing.akv_bak), stable))
        # interface array with background top/bottom rows
        bak = torch.full_like(Ak_i[:1], cfg.mixing.akv_bak)
        Akv = torch.cat([bak, Ak_i[1:-1], bak], dim=0)
        Akt = torch.stack([Akv for _ in range(cfg.NAT)])
        return Akv, Akt

    return vmix


def default_vmix(cfg: ModelConfig):
    """Constant background vertical mixing (mod_mixing defaults)."""
    def vmix(state, grid, z_w):
        Akv = torch.full_like(z_w, cfg.mixing.akv_bak)
        Akt = torch.stack([torch.full_like(z_w, ab)
                           for ab in cfg.mixing.akt_bak])
        return Akv, Akt
    return vmix


def _check_config(cfg: ModelConfig):
    m = cfg.mixing
    if cfg.prsgrd != "djs":
        raise NotImplementedError(
            f"pressure gradient '{cfg.prsgrd}': ROADMAP Queue 1 item 7")
    if cfg.step2d != "lf_am3":
        raise NotImplementedError("FB barotropic engine: ROADMAP Queue 1 "
                                  "item 7")
    if m.smagorinsky:
        raise NotImplementedError(
            "Smagorinsky mixing: ROADMAP Queue 1 item 7")
    if m.mix_iso_ts:
        raise NotImplementedError(
            "isopycnal tracer mixing (MIX_ISO_TS): ROADMAP Queue 1 item 7")
    if m.mix_geo_uv:
        raise NotImplementedError(
            "geopotential momentum mixing (MIX_GEO_UV): ROADMAP Queue 1 "
            "item 7")
    if cfg.omega_implicit:
        raise NotImplementedError("OMEGA_IMPLICIT: ROADMAP Queue 1 item 7")
    if cfg.wetdry:
        raise NotImplementedError("WET_DRY: ROADMAP Queue 1 item 7")


def kpp_route(cfg: ModelConfig) -> Optional[str]:
    """The LMD-KPP route of the step (roms_tpu/core/stepping.py:194-
    200, 296-341): "prep" (EOS and KPP fused, kernel 15) in its class;
    "whole_array" for LMD with LMD_BKPP or LMD_DDMIX, roms_tpu's jnp
    route (EOS through kernel 1, then core/lmd.py, whose spline solves
    go through kernel 17); None without LMD.  roms_tpu takes KPP alone
    (kernel 14, :308-318) only beside a BBL closure, which the port does
    not run yet."""
    if prep_op.covers(cfg):
        return "prep"
    return "whole_array" if cfg.mixing.vmix == "lmd" else None


def whole_array_lmd(cfg: ModelConfig, grid: Grid, state, pden, bvf,
                    forcing, bustr, bvstr, use_kernels: bool = True,
                    ddmix: bool = True):
    """LMD on the whole-array route (roms_tpu/core/stepping.py:323-341):
    interior mixing, LMD_DDMIX's increments from alpha/beta at the
    interior W interfaces (T and S averaged to z_w; left out with
    ddmix=False, as roms_tpu's write-time diagnostics leave them out),
    the surface boundary layer, then LMD_BKPP's bottom layer with the
    surface layer's level as its guard.  Returns (Akv, Akt, ghats, hsbl,
    hbbl); hbbl is None without LMD_BKPP."""
    m = cfg.mixing
    z_r, z_w, Hz, t = state.z_r, state.z_w, state.Hz, state.t
    Akv, Akt = lmd_mod.lmd_vmix_interior(cfg, state.u, state.v, bvf, Hz,
                                         use_kernels)
    if m.ddmix and ddmix:
        from .rho_eos import eos_alpha_beta
        t_i = 0.5 * (t[:, 1:] + t[:, :-1])
        aob = eos_alpha_beta(cfg, t_i, z_w[1:-1])[2]
        Akt = lmd_mod.lmd_ddmix(cfg, t, aob, Akt)
    Akv, Akt, ghats, hsbl = lmd_mod.lmd_skpp(
        cfg, grid, t, state.u, state.v, pden, bvf, Hz, z_r, z_w, forcing,
        Akv, Akt, use_kernels=use_kernels)
    hbbl = None
    if m.bkpp:
        Akv, Akt, hbbl = lmd_mod.lmd_bkpp(
            cfg, grid, t, state.u, state.v, pden, bvf, Hz, z_r, z_w,
            forcing, bustr, bvstr, Akv, Akt,
            ksbl_guard=lmd_mod.surface_ksbl(z_w, hsbl),
            use_kernels=use_kernels)
    return Akv, Akt, ghats, hsbl, hbbl


class Model:
    """Static configuration plus the step function.

    forcing_fn(time) -> Forcing, or, for bulk fluxes,
    forcing_fn(time, sst, sss, rho_surf, use_kernels) -> Forcing
    (core/bulk_flux.make_bulk_forcing), which gets the Model's
    use_kernels; vmix_fn(state, grid, z_w) -> (Akv, Akt), unused under
    LMD, GLS and MY2.5 mixing.  The device is the grid's.  fast_loop:
    the channel's fast-loop kernel engine, "resident" (kernel 11, the
    default) or "blocked" (kernel 12; core/step2d.fast_loop_kernel).
    """

    def __init__(self, cfg: ModelConfig, grid: Grid,
                 forcing_fn: Callable, vmix_fn: Optional[Callable] = None,
                 var_rho: bool = True, use_kernels: bool = True,
                 fast_loop: str = "resident", **hooks):
        for name, val in hooks.items():
            if name not in _LATER:
                raise TypeError(f"unexpected argument '{name}'")
            if val is not None:
                raise NotImplementedError(f"{name}: {_LATER[name]}")
        _check_config(cfg)
        self.cfg = cfg
        self.grid = grid
        self.forcing_fn = forcing_fn
        self._forcing_takes_state = (
            len(inspect.signature(forcing_fn).parameters) > 1)
        self.kpp_route = kpp_route(cfg)
        self.vmix_fn = vmix_fn or default_vmix(cfg)
        self.use_kernels = bool(use_kernels)
        self.nfast, w1, w2 = power_law_weights(cfg.ndtfast)
        self.fast_loop = make_fast_loop(cfg, self.nfast, w1, w2,
                                        var_rho=var_rho,
                                        use_kernels=self.use_kernels,
                                        engine=fast_loop)

    def _forcing(self, state: State, rho_surf):
        """The step's surface forcing; a bulk-flux forcing takes the
        ocean surface state and the Model's use_kernels."""
        if not self._forcing_takes_state:
            return self.forcing_fn(state.time)
        sss = state.t[1][-1] if self.cfg.NT > 1 \
            else torch.zeros_like(rho_surf)
        return self.forcing_fn(state.time, state.t[0][-1], sss, rho_surf,
                               use_kernels=self.use_kernels)

    def step(self, state: State) -> State:
        """One baroclinic step (main3d.F:216-1130)."""
        cfg, grid = self.cfg, self.grid
        kern = self.use_kernels
        z_r, z_w, Hz = state.z_r, state.z_w, state.Hz
        iic = state.iic

        # ---- prep: fluxes, EOS, forcing, closures (main3d.F:348-535) ----
        fused_flux = kern and flux_op.covers(cfg)
        if fused_flux:
            # set_massflux + omega in one kernel; W is reused below
            Huon, Hvom, W = flux_op.flux_omega(cfg, grid, state.u, state.v,
                                               Hz, z_w)
        else:
            Huon, Hvom = set_massflux(grid, state.u, state.v, Hz)
            if cfg.bc.ew_periodic:
                Huon, Hvom = st.periodic_x(Huon), st.periodic_x(Hvom)
            if cfg.bc.ns_periodic:
                Huon, Hvom = st.periodic_y(Huon), st.periodic_y(Hvom)
        route = self.kpp_route
        if route == "prep":
            # EOS and KPP share one kernel after the forcing; the bulk
            # fluxes need the top rho level first
            rho_surf = prep_op.surface_rho(cfg, state.t, z_r)
        else:
            rho, pden, rhoA, rhoS, bvf = rho_eos(cfg, state.t, z_r, Hz,
                                                 z_w, use_kernels=kern)
            rho_surf = rho[-1]
        forcing = self._forcing(state, rho_surf)
        bustr, bvstr = set_vbc.bottom_drag(cfg, grid, state.u, state.v,
                                           Hz, z_r, z_w)
        ghats_flux = None
        use_gls = cfg.mixing.vmix in ("gls", "my25")
        if use_gls:
            Akv, Akt = state.mix.Akv, state.mix.Akt
        elif route == "prep":
            (rho, _, rhoA, rhoS, Akv, Akt, ghats,
             _) = prep_op.prep_fused(cfg, grid, state.t, state.u, state.v,
                                     Hz, z_r, z_w, forcing,
                                     use_kernels=kern)
            ghats_flux = Akt * ghats
        elif route == "whole_array":
            Akv, Akt, ghats, _, _ = whole_array_lmd(
                cfg, grid, state, pden, bvf, forcing, bustr, bvstr, kern)
            ghats_flux = Akt * ghats
        else:
            Akv, Akt = self.vmix_fn(state, grid, z_w)
        if not fused_flux:
            W = omega_mod.omega(cfg, grid, Huon, Hvom, z_w)

        # ---- predictor stage (rhs3d.F:80-189) ---------------------------
        t_half, t_part, u_part, v_part = pre_step3d(
            cfg, grid, state.u, state.v, state.t, state.t_prev,
            state.ru_prev, state.rv_prev, state.ru_prev2, state.rv_prev2,
            Hz, z_r, z_w, Huon, Hvom, W, forcing, bustr, bvstr, iic,
            use_kernels=kern, ghats=ghats_flux)
        pgf = prsgrd_op.prsgrd32 if kern and prsgrd_op.covers(cfg, grid) \
            else prsgrd.prsgrd32
        ru, rv = pgf(cfg, grid, rho, z_r, z_w, Hz)
        if cfg.mixing.mix_geo_ts:
            t_part = hmix.t3dmix2_geo(cfg, grid, state.t, t_part, Hz, z_r,
                                      use_kernels=kern)
            t_part = hmix.t3dmix4_geo(cfg, grid, state.t, t_part, Hz, z_r,
                                      use_kernels=kern)
        else:
            t_part = hmix.t3dmix2_s(cfg, grid, state.t, t_part, Hz)
            t_part = hmix.t3dmix4_s(cfg, grid, state.t, t_part, Hz)
        ru, rv = rhs3d.rhs3d_momentum(cfg, grid, state.u, state.v, Hz,
                                      Huon, Hvom, W, ru, rv,
                                      use_kernels=kern)
        rufrc, rvfrc = rhs3d.integrate_rufrc(cfg, grid, ru, rv, forcing,
                                             bustr, bvstr)
        u_part, v_part, rufrc, rvfrc = hmix.uv3dmix2_s(
            cfg, grid, state.u, state.v, u_part, v_part, Hz, rufrc, rvfrc,
            use_kernels=kern)
        u_part, v_part, rufrc, rvfrc = hmix.uv3dmix4_s(
            cfg, grid, state.u, state.v, u_part, v_part, Hz, rufrc, rvfrc)
        if use_gls:
            # gls_prestep (main3d.F:634-636): AB2 advection of tke/psi
            half = gls_mod.gls_prestep(cfg, grid, state.mix, Huon, Hvom, W,
                                       Hz, iic)

        # ---- fast barotropic sub-cycle (main3d.F:810-918) ---------------
        avg, rufrc_eff, rvfrc_eff, _, _, _ = self.fast_loop(
            grid, state.zeta, state.ubar, state.vbar, rufrc, rvfrc,
            rhoS, rhoA, state.ru0_prev, state.rv0_prev,
            state.ru0_prev2, state.rv0_prev2, iic)

        # ---- new depths from the filtered free surface (main3d.F:963) ---
        z_r2, z_w2, Hz2 = set_depth(grid, avg.Zt_avg1)

        # ---- correctors (main3d.F:990-1045) -----------------------------
        un, vn, ubar, vbar, Huon2, Hvom2 = step3d_uv(
            cfg, grid, u_part, v_part, ru, rv, Hz2, Akv, avg, Huon, Hvom,
            iic, use_kernels=kern)
        W2 = (flux_op.omega if fused_flux else omega_mod.omega)(
            cfg, grid, Huon2, Hvom2, z_w2)
        mix_new = state.mix
        if use_gls:
            # gls_corstep / my25_corstep (main3d.F:1019-1021) runs before
            # step3d_t, so tracers diffuse with the new Akt
            corstep = my25_mod.my25_corstep if cfg.mixing.vmix == "my25" \
                else gls_mod.gls_corstep
            mix_new = corstep(cfg, grid, state.mix, *half, state.u, state.v,
                              Hz2, z_r2, z_w2, Huon2, Hvom2, W2, bvf,
                              forcing.sustr, forcing.svstr, bustr, bvstr,
                              use_kernels=kern)
            Akt = mix_new.Akt
        tn = step3d_t(cfg, grid, t_half, t_part, Huon2, Hvom2, W2, Hz2,
                      Akt, use_kernels=kern)

        return State(
            time=state.time + cfg.dt, iic=iic + 1,
            zeta=avg.Zt_avg1, ubar=ubar, vbar=vbar,
            u=un, v=vn, t=tn, t_prev=state.t,
            ru_prev=ru, rv_prev=rv,
            ru_prev2=state.ru_prev, rv_prev2=state.rv_prev,
            ru0_prev=rufrc_eff, rv0_prev=rvfrc_eff,
            ru0_prev2=state.ru0_prev, rv0_prev2=state.rv0_prev,
            z_r=z_r2, z_w=z_w2, Hz=Hz2, mix=mix_new)

    def diagnose(self, state: State) -> dict:
        """Write-time diagnostic fields (wrt_his.F derived quantities;
        roms_tpu Model.diagnose): the surface forcing the step applies,
        the bottom stress, and the vertical mixing coefficients (with the
        boundary-layer depth Hsbl under LMD-KPP), from the step's own
        prep code with each kernel on its route (the fused EOS + KPP of
        kernel 15 on BENCHMARK's route, the EOS of kernel 1 elsewhere),
        the bottom boundary-layer depth hbbl too under LMD_BKPP.
        GLS/MY2.5 runs write their coefficients from state.mix."""
        cfg, grid = self.cfg, self.grid
        z_r, z_w, Hz = state.z_r, state.z_w, state.Hz
        route = self.kpp_route
        if route == "prep":
            rho_surf = prep_op.surface_rho(cfg, state.t, z_r)
        else:
            _, pden, _, _, bvf = eos = rho_eos(
                cfg, state.t, z_r, Hz, z_w, use_kernels=self.use_kernels)
            rho_surf = eos[0][-1]
        forcing = self._forcing(state, rho_surf)
        out = {"sustr": forcing.sustr, "svstr": forcing.svstr,
               "shflux": forcing.stflx[0], "swrad": forcing.srflx}
        if cfg.NT > 1:
            out["ssflux"] = forcing.stflx[1]
        components = getattr(self.forcing_fn, "components", None)
        if components is not None:
            sss = state.t[1][-1] if cfg.NT > 1 \
                else torch.zeros_like(rho_surf)
            out.update(components(state.time, state.t[0][-1], sss,
                                  rho_surf))
        out["bustr"], out["bvstr"] = set_vbc.bottom_drag(
            cfg, grid, state.u, state.v, Hz, z_r, z_w)
        if route == "prep":
            (*_, Akv, Akt, _, hsbl) = prep_op.prep_fused(
                cfg, grid, state.t, state.u, state.v, Hz, z_r, z_w,
                forcing, use_kernels=self.use_kernels)
            out["hsbl"] = hsbl
        elif route == "whole_array":
            # roms_tpu's diagnose leaves LMD_DDMIX's increments out
            Akv, Akt, _, out["hsbl"], hbbl = whole_array_lmd(
                cfg, grid, state, pden, bvf, forcing, out["bustr"],
                out["bvstr"], self.use_kernels, ddmix=False)
            if hbbl is not None:
                out["hbbl"] = hbbl
        elif cfg.mixing.vmix not in ("gls", "my25"):
            Akv, Akt = self.vmix_fn(state, grid, z_w)
        else:
            return out
        out["AKv"] = Akv
        out["AKt"] = Akt[0]
        if cfg.NT > 1:
            out["AKs"] = Akt[1]
        return out

    def step_diag(self, state: State):
        """DIAGNOSTICS_TS budgets (step_impl collect_diag)."""
        raise NotImplementedError(
            "collect_diag tracer budgets: ROADMAP Queue 1 item 10")

    def step_diag_uv(self, state: State):
        """DIAGNOSTICS_UV budgets (step_impl collect_diag_uv)."""
        raise NotImplementedError(
            "collect_diag_uv momentum budgets: ROADMAP Queue 1 item 10")

    def run(self, state: State, nsteps: int) -> State:
        """Advance nsteps baroclinic steps."""
        for _ in range(nsteps):
            state = self.step(state)
        return state
