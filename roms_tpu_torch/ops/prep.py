"""Kernel 15: the fused prep column, EOS + LMD-KPP in one launch
(csrc/kpp.cu, prep mode).

Replaces roms_tpu/ops/pallas_prep.py `prep_pallas` and its wrapper
`prep_fused`.  The kernel runs the column EOS of kernel 1
(csrc/rho_col.cuh) and then the KPP column of kernel 14 on the density
and stratification it has just formed: pden is written once as an output
and read back from L2, bvf stays in the thread's shared-memory slots.
It writes Akt and ghats stacked over the active tracers, as the step
takes them.  The plain version is kernel 1's plain version followed by
kernel 14's (`rho_eos_plain`, `kpp_block`).

The bulk fluxes sit between the EOS and KPP in dataflow (they need the
surface density, KPP needs the fluxes), so the step computes the top
rho level alone (`surface_rho`, plain PyTorch as in roms_tpu) before the
forcing call and runs this kernel after it.  `covers` is the class of
roms_tpu's prep route (core/stepping.py:194-197): LMD mixing without
the bottom boundary layer or double diffusion; the step also needs no
BBL closure, which the port does not run yet.
"""

from __future__ import annotations

from . import kpp as kpp_op
from . import rho as rho_op


def covers(cfg) -> bool:
    return kpp_op.covers(cfg)


def surface_rho(cfg, t, z_r):
    """rho at the top rho level only, the bulk-flux air-density input
    (pallas_prep.py:40-49)."""
    from ..core.rho_eos import rho_eos_jm95, rho_eos_linear
    ts = t[:, -1]
    if cfg.eos.linear:
        return rho_eos_linear(cfg, ts[:, None])[0]
    return rho_eos_jm95(cfg, ts, z_r[-1])


def prep_plain(cfg, t, z_r, Hz, z_w, u_r, v_r, Ustar, Bo, Bosol, absf,
               flxT, flxS, srflx):
    """(rho, pden, rhoA, rhoS, Akv, Akt_profile, ghT, ghS, hsbl)."""
    rho, pden, rhoA, rhoS, bvf = rho_op.rho_eos_plain(cfg, t, z_r, Hz, z_w)
    return (rho, pden, rhoA, rhoS,
            *kpp_op.kpp_block(kpp_op.kpp_params(cfg), u_r, v_r, pden, bvf,
                              Hz, z_w, Ustar, Bo, Bosol, absf, flxT, flxS,
                              srflx))


def prep(cfg, t, z_r, Hz, z_w, u_r, v_r, Ustar, Bo, Bosol, absf, flxT,
         flxS, srflx):
    """Wrapper: plain version on CPU tensors, kernel on CUDA tensors
    (Akt_profile, ghT and ghS are then views of the stacked outputs)."""
    if t.device.type == "cpu":
        return prep_plain(cfg, t, z_r, Hz, z_w, u_r, v_r, Ustar, Bo, Bosol,
                          absf, flxT, flxS, srflx)
    return _launch(cfg, t, z_r, Hz, z_w, u_r, v_r, Ustar, Bo, Bosol, absf,
                   flxT, flxS, srflx)[0]


def _launch(cfg, t, z_r, Hz, z_w, u_r, v_r, *planes):
    return kpp_op.launch_column(cfg, "prep", [u_r, v_r, Hz, z_w],
                                list(planes), t=t, z_r=z_r)


def prep_fused(cfg, grid, t, u, v, Hz, z_r, z_w, forcing,
               use_kernels: bool = True):
    """rho_eos + LMD-KPP of the BENCHMARK physics (no BKPP/DDMIX):
    returns (rho, pden, rhoA, rhoS, Akv, Akt, ghats, hsbl), Akt and
    ghats stacked over the NAT active tracers (by the kernel itself on
    CUDA tensors).  The 2-D inputs are prepared as for kernel 14
    (pallas_prep.py:132-169)."""
    (u_r, v_r, Ustar, Bo, Bosol, absf, flxT, flxS,
     srflx) = kpp_op.surface_forcing(cfg, grid, t, u, v, forcing)
    args = (cfg, t, z_r, Hz, z_w, u_r, v_r, Ustar, Bo, Bosol, absf, flxT,
            flxS, srflx)
    if use_kernels and t.device.type != "cpu":
        outs, Akt, ghats = _launch(*args)
        rho, pden, rhoA, rhoS, Akv, *_, hsbl = outs
        return rho, pden, rhoA, rhoS, Akv, Akt, ghats, hsbl
    rho, pden, rhoA, rhoS, Akv, Akt_prof, ghT, ghS, hsbl = prep_plain(*args)
    return (rho, pden, rhoA, rhoS, Akv,
            *kpp_op.stack_tracers(cfg, Akt_prof, ghT, ghS), hsbl)
