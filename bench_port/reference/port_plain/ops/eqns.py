"""Equation-system algebra: P<->U conversions, fluxes, wave speeds.

Counterpart of the reference equation classes
(reference: source/equations/eqns_hydro_adiabatic.cpp:89-346,
source/equations/eqns_mhd_adiabatic.cpp:79-355,598-660).  All functions are
pure and vectorized over tensors that carry the variable index on the
LEADING axis, ``P.shape == (nvar, *spatial)``, so each component ``P[RO]``
is a contiguous spatial tensor.  Nothing here writes into its arguments.

"Sweep frame": flux/Riemann routines assume the sweep direction occupies the
VX/BX slots.  :func:`sweep_perm` builds the cyclic slot permutation that maps
a state into/out of that frame (the vectorized equivalent of the reference's
``eqns_base::rotate``, eqns_mhd_adiabatic.cpp:383-416).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, SI, VX, VY, VZ, Eqn

BASE_RHO = 1.0e-5  # density floor factor (reference: source/constants.h:339)
# underflows to 0 in float32, as in the reference implementation; kept so
MACHINE_EPS = 1.0e-300


def sweep_perm(cfg: SimConfig, axis: int) -> np.ndarray:
    """Slot permutation moving array-axis ``axis`` into the VX/BX slots.

    ``axis`` is in array order (0 = slowest).  The physical axis index is
    ``k = ndim-1-axis`` (x is the last array axis); the permutation is the
    cyclic rotation x->y->z like the reference's ``rotate()``.
    Apply as ``P_sweep = P[perm]``; invert with ``F = F_sweep[inv]`` where
    ``inv = inverse_perm(perm)``.
    """
    k = cfg.ndim - 1 - axis
    perm = np.arange(cfg.nvar)
    perm[VX] = VX + k
    perm[VY] = VX + (k + 1) % 3
    perm[VZ] = VX + (k + 2) % 3
    if cfg.eqn.is_mhd:
        perm[BX] = BX + k
        perm[BY] = BX + (k + 1) % 3
        perm[BZ] = BX + (k + 2) % 3
    return perm


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def permute(A: torch.Tensor, perm) -> torch.Tensor:
    """``A[perm]`` along the variable axis as a stack of views (no index
    tensor, so nothing is copied to the device per call)."""
    return torch.stack([A[int(p)] for p in perm])


# ---------------------------------------------------------------------------
# P <-> U
# ---------------------------------------------------------------------------

def prim_to_cons(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Primitive -> conserved (reference: eqns_hydro_adiabatic.cpp:89-105,
    eqns_mhd_adiabatic.cpp:79-100,598-609)."""
    g = cfg.gamma
    rho = P[RO]
    v2 = P[VX] ** 2 + P[VY] ** 2 + P[VZ] ** 2
    E = 0.5 * rho * v2 + P[PG] / (g - 1.0)
    U = [rho, None, rho * P[VX], rho * P[VY], rho * P[VZ]]
    if cfg.eqn.is_mhd:
        b2 = P[BX] ** 2 + P[BY] ** 2 + P[BZ] ** 2
        E = E + 0.5 * b2
        U += [P[BX], P[BY], P[BZ]]
        if cfg.eqn is Eqn.GLM:
            E = E + 0.5 * P[SI] ** 2
            U += [P[SI]]
    U[1] = E
    tr = [P[i] * rho for i in range(cfg.eqn.nbase, cfg.nvar)]
    return torch.stack(U + tr)


def cons_to_prim(U: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Conserved -> primitive with density/pressure floors.

    The reference recovers from rho<=0 by resetting to a floor density and
    from p<=0 by a pressure floor (reference: eqns_hydro_adiabatic.cpp:140-198,
    eqns_mhd_adiabatic.cpp:137-225).  Branches become ``where`` masks.
    """
    g = cfg.gamma
    rho_floor = BASE_RHO if cfg.eqn is Eqn.EULER else BASE_RHO * cfg.rho_ref
    rho = torch.where(U[RO] > 0.0, U[RO], rho_floor)
    vx, vy, vz = U[VX] / rho, U[VY] / rho, U[VZ] / rho
    ke = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    e_int = U[PG] - ke
    out = [rho, None, vx, vy, vz]
    if cfg.eqn.is_mhd:
        b2 = U[BX] ** 2 + U[BY] ** 2 + U[BZ] ** 2
        e_int = e_int - 0.5 * b2
        out += [U[BX], U[BY], U[BZ]]
        if cfg.eqn is Eqn.GLM:
            e_int = e_int - 0.5 * U[SI] ** 2
            out += [U[SI]]
    pg = (g - 1.0) * e_int
    if cfg.eqn is Eqn.EULER:
        pg = torch.where(pg > 0.0, pg, 0.01 * rho)   # :195
    else:
        pg = torch.where(pg > 0.0, pg, 1.0e-6 * cfg.p_ref)  # :219
    out[1] = pg
    tr = [U[i] / rho for i in range(cfg.eqn.nbase, cfg.nvar)]
    return torch.stack(out + tr)


# ---------------------------------------------------------------------------
# Fluxes (sweep frame: VX/BX normal to the interface)
# ---------------------------------------------------------------------------

def flux_from_pu(P: torch.Tensor, U: torch.Tensor,
                 cfg: SimConfig) -> torch.Tensor:
    """x-flux from primitive+conserved state, excluding tracer slots
    (reference: eqns_hydro_adiabatic.cpp:309-322, eqns_mhd_adiabatic.cpp:308-328).

    For GLM the BX/PSI flux slots are overwritten by the caller with the
    Dedner 2x2 solution, so they are left at the ideal-MHD values here.
    """
    mx = U[VX]
    f = [mx, None, None, mx * P[VY], mx * P[VZ]]
    if cfg.eqn is Eqn.EULER:
        f[2] = mx * P[VX] + P[PG]
        f[1] = P[VX] * (U[PG] + P[PG])
    else:
        pm = 0.5 * (U[BX] ** 2 + U[BY] ** 2 + U[BZ] ** 2)
        f[2] = mx * P[VX] + P[PG] + pm - U[BX] * U[BX]
        f[3] = f[3] - U[BX] * U[BY]
        f[4] = f[4] - U[BX] * U[BZ]
        udotb = P[VX] * U[BX] + P[VY] * U[BY] + P[VZ] * U[BZ]
        f[1] = P[VX] * (U[PG] + P[PG] + pm) - U[BX] * udotb
        f += [
            torch.zeros_like(mx),                     # F(Bx) = 0 (ideal)
            P[VX] * P[BY] - P[VY] * P[BX],
            P[VX] * P[BZ] - P[VZ] * P[BX],
        ]
        if cfg.eqn is Eqn.GLM:
            f += [torch.zeros_like(mx)]               # F(psi), set by caller
    ztr = [torch.zeros_like(mx)] * cfg.ntracer
    return torch.stack(f + ztr)


def flux_from_prim(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    return flux_from_pu(P, prim_to_cons(P, cfg), cfg)


# ---------------------------------------------------------------------------
# Wave speeds
# ---------------------------------------------------------------------------

def sound_speed(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Adiabatic sound speed (reference: eqns_hydro_adiabatic.cpp:208-214)."""
    return torch.sqrt(cfg.gamma * P[PG] / P[RO])


def cfast_components(rho, pg, bx, by, bz, gamma) -> torch.Tensor:
    """Fast magnetosonic speed along the bx direction
    (reference: eqns_mhd_adiabatic.cpp:264-278).

    float32-safe form: the discriminant is evaluated as
    t1^2 (1 - q), q = 4 (a2/t1)(bx^2/rho)/t1 in [0, 1] — t1^2 itself
    overflows float32 in evacuated wind interiors (b^2/rho ~ 4e19 cgs gives
    t1^2 ~ 2e39 > the float32 maximum)."""
    a2 = gamma * pg / rho
    t1 = a2 + (bx * bx + by * by + bz * bz) / rho
    q = 4.0 * (a2 / t1) * ((bx * bx / rho) / t1)
    root = torch.sqrt(torch.clamp(1.0 - q, min=0.0))
    return torch.sqrt(0.5 * t1 * (1.0 + root))


def cfast(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    return cfast_components(P[RO], P[PG], P[BX], P[BY], P[BZ], cfg.gamma)


def cslow(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Slow magnetosonic speed (reference: eqns_mhd_adiabatic.cpp:286-299).
    Same overflow-safe discriminant as cfast_components."""
    a2 = cfg.gamma * P[PG] / P[RO]
    t1 = a2 + (P[BX] ** 2 + P[BY] ** 2 + P[BZ] ** 2) / P[RO]
    q = 4.0 * (a2 / t1) * ((P[BX] ** 2 / P[RO]) / t1)
    root = torch.sqrt(torch.clamp(1.0 - q, min=0.0))
    return torch.sqrt(0.5 * torch.clamp(t1 * (1.0 - root), min=MACHINE_EPS))


def maxspeed(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Fastest signal speed normal to the sweep (sound or fast speed)."""
    if cfg.eqn is Eqn.EULER:
        return sound_speed(P, cfg)
    return cfast(P, cfg)


# ---------------------------------------------------------------------------
# Derived scalars
# ---------------------------------------------------------------------------

def e_total(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Total energy density from primitives."""
    return prim_to_cons(P, cfg)[PG]


def p_total(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    if cfg.eqn is Eqn.EULER:
        return P[PG]
    return P[PG] + 0.5 * (P[BX] ** 2 + P[BY] ** 2 + P[BZ] ** 2)
