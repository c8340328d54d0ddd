"""MHD Riemann solvers, vectorized over interface tensors.

Counterparts of the reference MHD solver menu
(reference: source/Riemann_solvers/HLLD_MHD.cpp (Miyoshi & Kusano 2005)).
Ported so far: HLL, HLLD and the per-interface HLLD->HLL fallback; the
Roe conserved-variable and the linear eigenvector solvers are not.

All functions work in the sweep frame (VX/BX normal) and return
``(flux, ustar)`` in conserved variables for the interface state (matching
the reference, which converts ustar->pstar afterwards).  Only the 8 physical
slots are populated; psi/tracer slots are zeroed (the sweep routine owns the
Dedner 2x2 psi flux and tracer upwinding).
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, VX, VY, VZ
from .eqns import cfast_components, flux_from_prim, prim_to_cons

_TINY = 1.0e-30


def _signal_speeds(Pl, Pr, cfg: SimConfig):
    """HLL/HLLD wave-speed estimates (reference: HLLD_MHD.cpp:342-368)."""
    bx = 0.5 * (Pl[BX] + Pr[BX])
    cf_l = cfast_components(Pl[RO], Pl[PG], bx, Pl[BY], Pl[BZ], cfg.gamma)
    cf_r = cfast_components(Pr[RO], Pr[PG], bx, Pr[BY], Pr[BZ], cfg.gamma)
    cmax = torch.maximum(cf_l, cf_r)
    sl = torch.minimum(Pl[VX], Pr[VX]) - cmax
    sr = torch.maximum(Pl[VX], Pr[VX]) + cmax
    return sl, sr


def _interface_common(Pl, Pr, cfg: SimConfig):
    """Conserved states, fluxes and HLL wave speeds for one interface —
    shared between HLLD and its HLL fallback so the fallback costs only the
    (cheap) HLL mid-state algebra, not a second full state conversion."""
    from .eqns import flux_from_pu

    ul = prim_to_cons(Pl, cfg)
    ur = prim_to_cons(Pr, cfg)
    fl = flux_from_pu(Pl, ul, cfg)
    fr = flux_from_pu(Pr, ur, cfg)
    sl, sr = _signal_speeds(Pl, Pr, cfg)
    return ul, ur, fl, fr, sl, sr


def hll(Pl, Pr, cfg: SimConfig, common=None):
    """Two-wave HLL flux (reference: HLLD_MHD.cpp:380-430 MHD_HLL_flux_solver).

    Single-formula form with clamped wave speeds lp=max(sr,0), lm=min(sl,0):
    f = (lp*fl - lm*fr + lp*lm*(ur-ul)) / (lp-lm) reproduces all three
    regions of the reference's if-tree exactly (sl>0 -> lp/lp=1 -> fl;
    sr<0 -> fr; else the mid-state flux) without per-channel selects."""
    ul, ur, fl, fr, sl, sr = common or _interface_common(Pl, Pr, cfg)
    lp = torch.clamp(sr, min=0.0)
    lm = torch.clamp(sl, max=0.0)
    inv = 1.0 / (lp - lm)
    c_l = lp * inv
    c_r = -lm * inv
    c_u = lp * lm * inv
    f = c_l * fl + c_r * fr + c_u * (ur - ul)
    ustar = (sr * ur - sl * ul + fl - fr) / (sr - sl)
    return f, ustar


def hlld(Pl, Pr, cfg: SimConfig, common=None):
    """HLLD five-wave solver (Miyoshi & Kusano 2005; reference:
    HLLD_MHD.cpp:120-335).  Branch structure becomes nested ``where`` masks;
    the Bx->0 degeneracy is guarded exactly as in the paper (eq. 44-47)."""
    g = cfg.gamma
    bx = 0.5 * (Pl[BX] + Pr[BX])

    ul, ur, fl, fr, sl, sr = common or _interface_common(Pl, Pr, cfg)

    ptl = Pl[PG] + 0.5 * (bx * bx + Pl[BY] ** 2 + Pl[BZ] ** 2)
    ptr = Pr[PG] + 0.5 * (bx * bx + Pr[BY] ** 2 + Pr[BZ] ** 2)
    sl_vl = sl - Pl[VX]
    sr_vr = sr - Pr[VX]
    inv_denom = 1.0 / (sr_vr * Pr[RO] - sl_vl * Pl[RO])
    # entropy-wave speed S_M (m05 eq. 38)
    sm = (sr_vr * ur[VX] - sl_vl * ul[VX] - ptr + ptl) * inv_denom
    # total pressure in the star region (m05 eq. 41)
    pts = (sr_vr * Pr[RO] * ptl - sl_vl * Pl[RO] * ptr
           + Pl[RO] * Pr[RO] * sr_vr * sl_vl * (Pr[VX] - Pl[VX])) * inv_denom

    def star(PK, uK, sK, sK_vK, ptK):
        sK_sm = sK - sm
        inv_sK_sm = 1.0 / sK_sm
        rho_s = PK[RO] * sK_vK * inv_sK_sm                  # m05 eq. 43
        # m05 eq. 44/46-47 with degeneracy guard
        dd = PK[RO] * sK_vK * sK_sm - bx * bx
        degenerate = torch.abs(dd) < _TINY * (PK[RO] * sK_vK * sK_vK + bx * bx + _TINY)
        inv_dd = 1.0 / torch.where(degenerate, 1.0, dd)
        fac_v = bx * (sm - PK[VX]) * inv_dd
        vy_s = torch.where(degenerate, PK[VY], PK[VY] - PK[BY] * fac_v)
        vz_s = torch.where(degenerate, PK[VZ], PK[VZ] - PK[BZ] * fac_v)
        fac_b = (PK[RO] * sK_vK * sK_vK - bx * bx) * inv_dd
        by_s = torch.where(degenerate, PK[BY], PK[BY] * fac_b)
        bz_s = torch.where(degenerate, PK[BZ], PK[BZ] * fac_b)
        vdotb_K = PK[VX] * bx + PK[VY] * PK[BY] + PK[VZ] * PK[BZ]
        vdotb_s = sm * bx + vy_s * by_s + vz_s * bz_s
        e_s = (sK_vK * uK[PG] - ptK * PK[VX] + pts * sm
               + bx * (vdotb_K - vdotb_s)) * inv_sK_sm       # m05 eq. 48
        us = [rho_s, e_s, rho_s * sm, rho_s * vy_s, rho_s * vz_s,
              bx.expand_as(rho_s), by_s, bz_s]
        pad = [torch.zeros_like(rho_s)] * (PK.shape[0] - 8)
        return torch.stack(us + pad), vy_s, vz_s, by_s, bz_s

    uls, vyl_s, vzl_s, byl_s, bzl_s = star(Pl, ul, sl, sl_vl, ptl)
    urs, vyr_s, vzr_s, byr_s, bzr_s = star(Pr, ur, sr, sr_vr, ptr)

    # Alfven-wave speeds in the star region (m05 eq. 51)
    sqrt_rls = torch.sqrt(uls[RO])
    sqrt_rrs = torch.sqrt(urs[RO])
    sls = sm - torch.abs(bx) / sqrt_rls
    srs = sm + torch.abs(bx) / sqrt_rrs

    # double-star states (m05 eq. 59-62)
    # sign(0) := +1 to avoid NaNs (the bool is cast before it is added)
    sgn_bx = torch.sign(bx) + (bx == 0.0).to(bx.dtype)
    inv_ssum = 1.0 / (sqrt_rls + sqrt_rrs)
    sqrt_rlrs = sqrt_rls * sqrt_rrs
    vy_ss = (sqrt_rls * vyl_s + sqrt_rrs * vyr_s + (byr_s - byl_s) * sgn_bx) * inv_ssum
    vz_ss = (sqrt_rls * vzl_s + sqrt_rrs * vzr_s + (bzr_s - bzl_s) * sgn_bx) * inv_ssum
    by_ss = (sqrt_rls * byr_s + sqrt_rrs * byl_s
             + sqrt_rlrs * (vyr_s - vyl_s) * sgn_bx) * inv_ssum
    bz_ss = (sqrt_rls * bzr_s + sqrt_rrs * bzl_s
             + sqrt_rlrs * (vzr_s - vzl_s) * sgn_bx) * inv_ssum
    vdotb_ss = sm * bx + vy_ss * by_ss + vz_ss * bz_ss

    def dstar(us, sq, vy_s, vz_s, by_s, bz_s, sgn):
        rho = us[RO]
        vdotb_s = sm * bx + vy_s * by_s + vz_s * bz_s
        e_ss = us[PG] + sgn * sq * (vdotb_s - vdotb_ss) * sgn_bx  # m05 eq. 63
        uss = [rho, e_ss, rho * sm, rho * vy_ss, rho * vz_ss,
               bx.expand_as(rho), by_ss, bz_ss]
        pad = [torch.zeros_like(rho)] * (us.shape[0] - 8)
        return torch.stack(uss + pad)

    ulss = dstar(uls, sqrt_rls, vyl_s, vzl_s, byl_s, bzl_s, -1.0)
    urss = dstar(urs, sqrt_rrs, vyr_s, vzr_s, byr_s, bzr_s, +1.0)

    # Flux assembly (m05 eq. 64-66; reference :294-325)
    f_ls = fl + sl * (uls - ul)
    f_lss = fl + sls * ulss - (sls - sl) * uls - sl * ul
    f_rss = fr + srs * urss - (srs - sr) * urs - sr * ur
    f_rs = fr + sr * (urs - ur)

    f = torch.where(
        sl > 0.0, fl,
        torch.where(
            sls >= 0.0, f_ls,
            torch.where(
                sm >= 0.0, f_lss,
                torch.where(srs >= 0.0, f_rss, torch.where(sr >= 0.0, f_rs, fr)),
            ),
        ),
    )
    ustar = torch.where(
        sl > 0.0, ul,
        torch.where(
            sls >= 0.0, uls,
            torch.where(
                sm >= 0.0, ulss,
                torch.where(srs >= 0.0, urss, torch.where(sr >= 0.0, urs, ur)),
            ),
        ),
    )
    return f, ustar


def hlld_with_hll_fallback(Pl, Pr, cfg: SimConfig, use_hll_mask=None):
    """HLLD with per-interface HLL fallback in compressive strong-gradient
    zones (reference: solver_eqn_mhd_adi.cpp:167-185, Mignone et al. 2011).

    ``use_hll_mask`` is a boolean interface array computed by the sweep routine
    from div(v)<0 and |grad p|*dx/p > 5.  The conserved states, fluxes and
    wave speeds are computed once and shared between both solvers.
    """
    if use_hll_mask is None:
        return hlld(Pl, Pr, cfg)
    common = _interface_common(Pl, Pr, cfg)
    f_d, u_d = hlld(Pl, Pr, cfg, common)
    f_h, u_h = hll(Pl, Pr, cfg, common)
    return (
        torch.where(use_hll_mask, f_h, f_d),
        torch.where(use_hll_mask, u_h, u_d),
    )
