"""Hydrodynamic Riemann solvers, vectorized over interface tensors.

Counterparts of the reference solver menu for the Euler system
(reference: source/Riemann_solvers/: HLL_hydro.cpp, riemann.cpp (exact and
linear), Roe_Hydro_ConservedVar_solver.cpp, Roe_Hydro_PrimitiveVar_solver.cpp,
Riemann_FVS_hydro.cpp), each ported from the function of the same name in
``pion_tpu/ops/riemann_hydro.py``.  Every per-interface scalar branch of the
C++ is a ``torch.where`` mask over whole interface tensors; the exact solver's
Newton iteration is a fixed-depth masked iteration.

All functions work in the sweep frame (VX normal) and return
``(flux, pstar)`` with only the first 5 slots populated; tracer slots are
handled by the sweep routine.  Nothing here writes into its arguments.
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from ..constants import PG, RO, VX, VY, VZ
from .eqns import cons_to_prim, flux_from_prim, prim_to_cons, sound_speed

_SMALL = 1.0e-12


def _stack5(ro, pg, vx, vy, vz, like):
    """Stack 5 hydro slots and zero-pad to nvar like ``like``."""
    pad = [torch.zeros_like(ro)] * (like.shape[0] - 5)
    out = [None] * 5
    out[RO], out[PG], out[VX], out[VY], out[VZ] = ro, pg, vx, vy, vz
    return torch.stack(out + pad)


# ---------------------------------------------------------------------------
# Lax-Friedrichs (reference: solver_eqn_base.cpp:109-141)
# ---------------------------------------------------------------------------

def lax_friedrichs(Pl, Pr, cfg: SimConfig, dx_over_dt):
    """``riemann_hydro.lax_friedrichs``; for MHD too (the sweep dispatches
    ``LF`` here for every equation system, as the reference does)."""
    ul = prim_to_cons(Pl, cfg)
    ur = prim_to_cons(Pr, cfg)
    fl = flux_from_prim(Pl, cfg)
    fr = flux_from_prim(Pr, cfg)
    f = 0.5 * (fl + fr + dx_over_dt * (ul - ur) / cfg.ndim)
    return f, 0.5 * (Pl + Pr)


# ---------------------------------------------------------------------------
# HLL (reference: HLL_hydro.cpp:92-161; Miyoshi & Kusano 2005 eq. 67 speeds)
# ---------------------------------------------------------------------------

def hll(Pl, Pr, cfg: SimConfig):
    """``riemann_hydro.hll``: the pstar is ``ustar`` converted with the
    Euler floors."""
    ul = prim_to_cons(Pl, cfg)
    ur = prim_to_cons(Pr, cfg)
    fl = flux_from_prim(Pl, cfg)
    fr = flux_from_prim(Pr, cfg)
    cmax = torch.maximum(sound_speed(Pl, cfg), sound_speed(Pr, cfg))
    sl = torch.minimum(Pl[VX], Pr[VX]) - cmax
    sr = torch.maximum(Pl[VX], Pr[VX]) + cmax
    f_mid = (sr * fl - sl * fr + sr * sl * (ur - ul)) / (sr - sl)
    f = torch.where(sl > 0.0, fl, torch.where(sr < 0.0, fr, f_mid))
    ustar = (sr * ur - sl * ul + fl - fr) / (sr - sl)
    return f, cons_to_prim(ustar, cfg)


# ---------------------------------------------------------------------------
# Roe conserved-variable solver, symmetric form with H-correction
# (reference: Roe_Hydro_ConservedVar_solver.cpp:129-560; Toro 11.2.2)
# ---------------------------------------------------------------------------

def roe_cv(Pl, Pr, cfg: SimConfig, hc_eta=None):
    """``riemann_hydro.roe_cv``; ``hc_eta`` floors |lambda| (the
    H-correction), None for none."""
    g = cfg.gamma
    rl = torch.sqrt(Pl[RO])
    rr = torch.sqrt(Pr[RO])
    denom = 1.0 / (rl + rr)
    # Enthalpy per unit mass (reference: eqns_hydro_adiabatic.cpp:356-364)
    v2l = Pl[VX] ** 2 + Pl[VY] ** 2 + Pl[VZ] ** 2
    v2r = Pr[VX] ** 2 + Pr[VY] ** 2 + Pr[VZ] ** 2
    Hl = 0.5 * v2l + g * Pl[PG] / (g - 1.0) / Pl[RO]
    Hr = 0.5 * v2r + g * Pr[PG] / (g - 1.0) / Pr[RO]
    rho_m = rl * rr
    vx = (rl * Pl[VX] + rr * Pr[VX]) * denom
    vy = (rl * Pl[VY] + rr * Pr[VY]) * denom
    vz = (rl * Pl[VZ] + rr * Pr[VZ]) * denom
    H = (rl * Hl + rr * Hr) * denom
    v2 = vx * vx + vy * vy + vz * vz
    a = torch.sqrt((g - 1.0) * torch.maximum(H - 0.5 * v2,
                                             _SMALL * v2 + 1e-300))

    lam = [vx - a, vx, vx, vx, vx + a]
    if hc_eta is not None:
        # |lambda| >= eta (Sanders et al. 1998; reference :369-380)
        lam = [torch.where(e < 0.0, torch.minimum(e, -hc_eta),
                           torch.maximum(e, hc_eta)) for e in lam]

    ul = prim_to_cons(Pl, cfg)
    ur = prim_to_cons(Pr, cfg)
    ud = ur - ul
    # Wave strengths (Toro eq. 11.68-70; reference :484-512)
    s2 = ud[VY] - vy * ud[RO]
    s3 = ud[VZ] - vz * ud[RO]
    u5bar = ud[PG] - s2 * vy - s3 * vz
    s1 = (ud[RO] * (H - vx * vx) + vx * ud[VX] - u5bar) * (g - 1.0) / (a * a)
    s0 = 0.5 * (ud[RO] * (vx + a) - ud[VX] - a * s1) / a
    s4 = ud[RO] - s0 - s1

    # Right eigenvectors (Toro eq. 11.59), slots (rho, E, mx, my, mz)
    one = torch.ones_like(vx)
    zero = torch.zeros_like(vx)
    K = [
        _stack5(one, H - vx * a, vx - a, vy, vz, Pl),
        _stack5(one, 0.5 * v2, vx, vy, vz, Pl),
        _stack5(zero, vy, zero, one, zero, Pl),
        _stack5(zero, vz, zero, zero, one, Pl),
        _stack5(one, H + vx * a, vx + a, vy, vz, Pl),
    ]
    strengths = [s0, s1, s2, s3, s4]
    f = flux_from_prim(Pl, cfg) + flux_from_prim(Pr, cfg)
    for s, e, k in zip(strengths, lam, K):
        f = f - s * torch.abs(e) * k
    f = 0.5 * f
    # pstar = Roe mean state with p from H (reference :573-600)
    p_m = (H - 0.5 * v2) * rho_m * (g - 1.0) / g
    pstar = _stack5(rho_m, p_m, vx, vy, vz, Pl)
    return f, pstar


# ---------------------------------------------------------------------------
# Exact/iterative and linear primitive-variable solvers
# (reference: riemann.cpp; findroot.cpp Newton-Raphson on p*)
# ---------------------------------------------------------------------------

def _fK(p, PK, cK, g):
    """Toro's f_K(p): velocity jump across the wave connecting to state K."""
    pK = PK[PG]
    AK = 2.0 / ((g + 1.0) * PK[RO])
    BK = (g - 1.0) / (g + 1.0) * pK
    shock = (p - pK) * torch.sqrt(AK / (p + BK))
    raref = 2.0 * cK / (g - 1.0) * ((p / pK) ** ((g - 1.0) / (2.0 * g)) - 1.0)
    return torch.where(p > pK, shock, raref)


def _fK_deriv(p, PK, cK, g):
    pK = PK[PG]
    AK = 2.0 / ((g + 1.0) * PK[RO])
    BK = (g - 1.0) / (g + 1.0) * pK
    shock = torch.sqrt(AK / (BK + p)) * (1.0 - 0.5 * (p - pK) / (BK + p))
    raref = (p / pK) ** (-(g + 1.0) / (2.0 * g)) / (PK[RO] * cK)
    return torch.where(p > pK, shock, raref)


def exact_pstar(Pl, Pr, cfg: SimConfig, n_iter: int = 30):
    """p*, v* via masked Newton iteration (fixed depth, all interfaces)."""
    g = cfg.gamma
    cl = sound_speed(Pl, cfg)
    cr = sound_speed(Pr, cfg)
    du = Pr[VX] - Pl[VX]
    # two-rarefaction initial guess, positively floored
    z = (g - 1.0) / (2.0 * g)
    p_tr = ((cl + cr - 0.5 * (g - 1.0) * du) /
            (cl / Pl[PG] ** z + cr / Pr[PG] ** z)) ** (1.0 / z)
    p = torch.maximum(p_tr, _SMALL * (Pl[PG] + Pr[PG]))
    for _ in range(n_iter):
        f = _fK(p, Pl, cl, g) + _fK(p, Pr, cr, g) + du
        df = _fK_deriv(p, Pl, cl, g) + _fK_deriv(p, Pr, cr, g)
        p = torch.maximum(p - f / df, 1.0e-8 * p)
    vstar = 0.5 * (Pl[VX] + Pr[VX] + _fK(p, Pr, cr, g) - _fK(p, Pl, cl, g))
    return p, vstar


def _sample_exact(Pl, Pr, pstar, vstar, cfg: SimConfig):
    """Sample the exact-RS solution at x/t=0 (Toro ch.4 sampling;
    reference: riemann.cpp solution sampling + HydroWaveFull density jumps)."""
    g = cfg.gamma
    gp1 = g + 1.0
    gm1 = g - 1.0

    def one_side(PK, sgn):
        # sgn=+1 for left wave, -1 for right wave
        cK = sound_speed(PK, cfg)
        pr_ratio = pstar / PK[PG]
        # star-region density: shock jump or adiabat
        rho_shock = PK[RO] * (gp1 / gm1 * pr_ratio + 1.0) / (gp1 / gm1 + pr_ratio)
        rho_raref = PK[RO] * pr_ratio ** (1.0 / g)
        rho_star = torch.where(pr_ratio > 1.0, rho_shock, rho_raref)
        c_star = torch.sqrt(g * pstar / rho_star)
        # wave speeds
        s_shock = PK[VX] - sgn * cK * torch.sqrt(
            gp1 / (2.0 * g) * pr_ratio + gm1 / (2.0 * g))
        head = PK[VX] - sgn * cK
        tail = vstar - sgn * c_star
        # in-fan state sampled at x/t=0 (Toro eq. 4.56 left / 4.63 right)
        fac = 2.0 / gp1 + sgn * gm1 / (gp1 * cK) * PK[VX]
        rho_fan = PK[RO] * fac ** (2.0 / gm1)
        v_fan = (2.0 / gp1) * (sgn * cK + gm1 / 2.0 * PK[VX])
        p_fan = PK[PG] * fac ** (2.0 * g / gm1)
        return rho_star, c_star, s_shock, head, tail, rho_fan, v_fan, p_fan, cK

    W = torch.where
    (rsl, _csl, ssl, hl, tl, rfl, vfl, pfl, _cl) = one_side(Pl, +1.0)
    (rsr, _csr, ssr, hr, tr_, rfr, vfr, pfr, _cr) = one_side(Pr, -1.0)

    # assemble solution at x/t = 0
    left_of_contact = vstar >= 0.0

    # Left side structure
    shock_l = pstar > Pl[PG]
    rho_l = W(shock_l, W(ssl >= 0.0, Pl[RO], rsl),
              W(hl >= 0.0, Pl[RO], W(tl <= 0.0, rsl, rfl)))
    v_l = W(shock_l, W(ssl >= 0.0, Pl[VX], vstar),
            W(hl >= 0.0, Pl[VX], W(tl <= 0.0, vstar, vfl)))
    p_l = W(shock_l, W(ssl >= 0.0, Pl[PG], pstar),
            W(hl >= 0.0, Pl[PG], W(tl <= 0.0, pstar, pfl)))

    shock_r = pstar > Pr[PG]
    rho_r = W(shock_r, W(ssr <= 0.0, Pr[RO], rsr),
              W(hr <= 0.0, Pr[RO], W(tr_ >= 0.0, rsr, rfr)))
    v_r = W(shock_r, W(ssr <= 0.0, Pr[VX], vstar),
            W(hr <= 0.0, Pr[VX], W(tr_ >= 0.0, vstar, vfr)))
    p_r = W(shock_r, W(ssr <= 0.0, Pr[PG], pstar),
            W(hr <= 0.0, Pr[PG], W(tr_ >= 0.0, pstar, pfr)))

    ro = W(left_of_contact, rho_l, rho_r)
    vx = W(left_of_contact, v_l, v_r)
    pg = W(left_of_contact, p_l, p_r)
    vy = W(left_of_contact, Pl[VY], Pr[VY])
    vz = W(left_of_contact, Pl[VZ], Pr[VZ])
    return _stack5(ro, pg, vx, vy, vz, Pl)


def _sample_cavitation(Pl, Pr, cfg: SimConfig):
    """Sampled state at x/t=0 when the data generate a vacuum
    (reference: riemann.cpp solve_cavitation; Toro §4.6.2): two complete
    rarefactions separated by a near-vacuum cavity floored at
    BASEPG * refvec (reference: constants.h:336 BASEPG=1e-5)."""
    g = cfg.gamma
    gm1 = g - 1.0
    gp1 = g + 1.0
    cl = sound_speed(Pl, cfg)
    cr = sound_speed(Pr, cfg)

    # left fan state at xi=0: local c = v there
    v_lf = (2.0 * cl + gm1 * Pl[VX]) / gp1
    r_lf = Pl[RO] * torch.clamp(v_lf / cl, min=_SMALL) ** (2.0 / gm1)
    p_lf = Pl[PG] * torch.clamp(r_lf / Pl[RO], min=_SMALL) ** g
    v_rf = (-2.0 * cr + gm1 * Pr[VX]) / gp1
    r_rf = Pr[RO] * torch.clamp(-v_rf / cr, min=_SMALL) ** (2.0 / gm1)
    p_rf = Pr[PG] * torch.clamp(r_rf / Pr[RO], min=_SMALL) ** g

    rho_vac = 1.0e-5 * cfg.rho_ref
    p_vac = 1.0e-5 * cfg.p_ref

    def pick(wl, lf, vac, rf, wr):
        W = torch.where
        return W(Pl[VX] - cl >= 0.0, wl,
                 W(Pl[VX] + 2.0 * cl / gm1 >= 0.0, lf,
                   W(Pr[VX] - 2.0 * cr / gm1 >= 0.0, vac,
                     W(Pr[VX] + cr > 0.0, rf, wr))))

    ro = pick(Pl[RO], r_lf, rho_vac, r_rf, Pr[RO])
    pg = pick(Pl[PG], p_lf, p_vac, p_rf, Pr[PG])
    vx = pick(Pl[VX], v_lf, 0.0, v_rf, Pr[VX])
    vy = torch.where(vx >= 0.0, Pl[VY], Pr[VY])
    vz = torch.where(vx >= 0.0, Pl[VZ], Pr[VZ])
    return _stack5(ro, pg, vx, vy, vz, Pl)


def exact(Pl, Pr, cfg: SimConfig):
    """Exact Riemann solver: p* Newton iteration + sampling at x/t=0
    (reference: riemann.cpp:43-225 'FLUX_RSexact'), with the
    vacuum-generating branch handled in closed form (riemann.cpp
    solve_cavitation — condition :321: u_R-u_L >= 2(c_L+c_R)/(g-1))."""
    pstar, vstar = exact_pstar(Pl, Pr, cfg)
    P0 = _sample_exact(Pl, Pr, pstar, vstar, cfg)
    g = cfg.gamma
    cl = sound_speed(Pl, cfg)
    cr = sound_speed(Pr, cfg)
    cav = (Pr[VX] - Pl[VX]) >= 2.0 * (cl + cr) / (g - 1.0)
    P0 = torch.where(cav, _sample_cavitation(Pl, Pr, cfg), P0)
    return flux_from_prim(P0, cfg), P0


def linear_pv(Pl, Pr, cfg: SimConfig):
    """Linearized primitive-variable solver about the arithmetic mean state
    (reference: riemann.cpp linear solver; Roe_Hydro_PrimitiveVar_solver.cpp).

    Solves the linearized characteristic equations for (rho*, v*, p*), then
    samples left/right of the contact.
    """
    W = torch.where
    cl = sound_speed(Pl, cfg)
    cr = sound_speed(Pr, cfg)
    rho_av = 0.5 * (Pl[RO] + Pr[RO])
    c_av = 0.5 * (cl + cr)
    rc = rho_av * c_av
    pstar = 0.5 * (Pl[PG] + Pr[PG]) - 0.5 * (Pr[VX] - Pl[VX]) * rc
    pstar = torch.maximum(pstar, _SMALL * (Pl[PG] + Pr[PG]))
    vstar = 0.5 * (Pl[VX] + Pr[VX]) - 0.5 * (Pr[PG] - Pl[PG]) / rc
    left = vstar >= 0.0
    PK_ro = W(left, Pl[RO], Pr[RO])
    PK_pg = W(left, Pl[PG], Pr[PG])
    rho_star = PK_ro + (pstar - PK_pg) / (c_av * c_av)
    rho_star = torch.maximum(rho_star, _SMALL * rho_av)

    # Supersonic cases: solution at x/t=0 is the upstream state itself.
    sup_l = Pl[VX] - cl > 0.0
    sup_r = Pr[VX] + cr < 0.0
    ro = W(sup_l, Pl[RO], W(sup_r, Pr[RO], rho_star))
    pg = W(sup_l, Pl[PG], W(sup_r, Pr[PG], pstar))
    vx = W(sup_l, Pl[VX], W(sup_r, Pr[VX], vstar))
    vy = W(left, Pl[VY], Pr[VY])
    vz = W(left, Pl[VZ], Pr[VZ])
    P0 = _stack5(ro, pg, vx, vy, vz, Pl)
    return flux_from_prim(P0, cfg), P0


def hybrid(Pl, Pr, cfg: SimConfig):
    """Linear solver with exact-solver fallback where the pressure jump is
    large (reference: riemann.cpp FLUX_RShybrid: linear unless the states
    differ strongly, then exact)."""
    f_lin, p_lin = linear_pv(Pl, Pr, cfg)
    f_ex, p_ex = exact(Pl, Pr, cfg)
    ratio = torch.maximum(Pl[PG], Pr[PG]) / torch.minimum(Pl[PG], Pr[PG])
    strong = ratio > 2.0
    return torch.where(strong, f_ex, f_lin), torch.where(strong, p_ex, p_lin)


# ---------------------------------------------------------------------------
# Roe-mean primitive-variable solver and van Leer flux-vector splitting
# (reference: Roe_Hydro_PrimitiveVar_solver.cpp, Riemann_FVS_hydro.cpp)
# ---------------------------------------------------------------------------

def _enthalpy(P, g):
    v2 = P[VX] ** 2 + P[VY] ** 2 + P[VZ] ** 2
    return 0.5 * v2 + g * P[PG] / ((g - 1.0) * P[RO])


def roe_average_state(Pl, Pr, cfg: SimConfig):
    """Roe-averaged primitive state (Toro eq. 11.60; reference:
    Riemann_FVS_hydro.cpp:204-240 Roe_average_state): sqrt(rho)-weighted
    velocities + enthalpy-mean pressure.  Returns (rho, pg, vx, vy, vz)."""
    g = cfg.gamma
    rl = torch.sqrt(Pl[RO])
    rr = torch.sqrt(Pr[RO])
    den = 1.0 / (rl + rr)
    rho = rl * rr
    vx = (rl * Pl[VX] + rr * Pr[VX]) * den
    vy = (rl * Pl[VY] + rr * Pr[VY]) * den
    vz = (rl * Pl[VZ] + rr * Pr[VZ]) * den
    H = (rl * _enthalpy(Pl, g) + rr * _enthalpy(Pr, g)) * den
    a2 = (g - 1.0) * (H - 0.5 * (vx * vx + vy * vy + vz * vz))
    a2 = torch.maximum(a2, _SMALL * (Pl[PG] + Pr[PG]) / (Pl[RO] + Pr[RO]))
    pg = rho * a2 / g
    return rho, pg, vx, vy, vz


def roe_pv(Pl, Pr, cfg: SimConfig):
    """Roe-mean primitive-variable linear solver (reference:
    Roe_Hydro_PrimitiveVar_solver.cpp Roe_prim_var_solver): the same
    two-characteristic linearization as ``linear_pv`` but about the
    Roe-averaged mean state, with supersonic pass-through on the mean
    eigenvalues and one-sided rho* from the acoustic jump."""
    W = torch.where
    rho_m, _pg_m, vx_m, vy_m, vz_m = roe_average_state(Pl, Pr, cfg)
    g = cfg.gamma
    rl = torch.sqrt(Pl[RO])
    rr = torch.sqrt(Pr[RO])
    den = 1.0 / (rl + rr)
    H = (rl * _enthalpy(Pl, g) + rr * _enthalpy(Pr, g)) * den
    v2_m = vx_m * vx_m + vy_m * vy_m + vz_m * vz_m
    a = torch.sqrt(torch.maximum((g - 1.0) * (H - 0.5 * v2_m),
                                 _SMALL * (Pl[PG] + Pr[PG])
                                 / (Pl[RO] + Pr[RO])))
    pstar = 0.5 * (Pl[PG] + Pr[PG] - rho_m * a * (Pr[VX] - Pl[VX]))
    pstar = torch.maximum(pstar, _SMALL * (Pl[PG] + Pr[PG]))
    vstar = 0.5 * (Pl[VX] + Pr[VX] - (Pr[PG] - Pl[PG]) / (rho_m * a))
    left = vstar > 0.0
    rho_star = W(left, Pl[RO] + rho_m * (Pl[VX] - vstar) / a,
                 Pr[RO] + rho_m * (vstar - Pr[VX]) / a)
    rho_star = torch.maximum(rho_star, _SMALL * rho_m)
    sup_l = vx_m - a >= 0.0
    sup_r = vx_m + a <= 0.0
    ro = W(sup_l, Pl[RO], W(sup_r, Pr[RO], rho_star))
    pg = W(sup_l, Pl[PG], W(sup_r, Pr[PG], pstar))
    vx = W(sup_l, Pl[VX], W(sup_r, Pr[VX], vstar))
    vy = W(sup_l, Pl[VY], W(sup_r, Pr[VY], W(left, Pl[VY], Pr[VY])))
    vz = W(sup_l, Pl[VZ], W(sup_r, Pr[VZ], W(left, Pl[VZ], Pr[VZ])))
    P0 = _stack5(ro, pg, vx, vy, vz, Pl)
    return flux_from_prim(P0, cfg), P0


def fvs(Pl, Pr, cfg: SimConfig):
    """van Leer flux-vector splitting (reference: Riemann_FVS_hydro.cpp:10-13;
    van Leer 1982); the interface state handed to the viscosity is the Roe
    average (reference: Riemann_FVS_hydro.cpp:177)."""
    g = cfg.gamma

    def split(P, sgn):
        c = sound_speed(P, cfg)
        M = P[VX] / c
        rho = P[RO]
        # mass flux: van Leer splitting
        f_mass_sub = sgn * rho * c * 0.25 * (M + sgn) ** 2
        f_mass_sup = torch.where(sgn * M >= 1.0, rho * P[VX], 0.0)
        sub = torch.abs(M) < 1.0
        f_mass = torch.where(sub, f_mass_sub, f_mass_sup)
        vx_term_sub = ((g - 1.0) * P[VX] + sgn * 2.0 * c) / g
        f_mom_sup = f_mass * P[VX] + torch.where(sgn * M >= 1.0, P[PG], 0.0)
        f_mom = torch.where(sub, f_mass * vx_term_sub, f_mom_sup)
        # energy: f_E = f_mass * [ ((g-1)vx ± 2c)^2 / (2(g^2-1)) + (vy²+vz²)/2 ]
        e_sub = ((g - 1.0) * P[VX] + sgn * 2.0 * c) ** 2 / (
            2.0 * (g + 1.0) * (g - 1.0))
        e_sup = 0.5 * P[VX] ** 2 + c * c / (g - 1.0)  # total specific enthalpy
        e_term = torch.where(sub, e_sub, e_sup)
        trans = 0.5 * (P[VY] ** 2 + P[VZ] ** 2)
        f_erg = f_mass * (e_term + trans)
        f_my = f_mass * P[VY]
        f_mz = f_mass * P[VZ]
        return f_mass, f_erg, f_mom, f_my, f_mz

    fl = split(Pl, +1.0)
    fr = split(Pr, -1.0)
    f = _stack5(*[a + b for a, b in zip(fl, fr)], Pl)
    ro, pg, vx, vy, vz = roe_average_state(Pl, Pr, cfg)
    return f, _stack5(ro, pg, vx, vy, vz, Pl)
