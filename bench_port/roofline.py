"""The chip's published peaks and the least time of the fused sweep's work.

Bytes: each input of a launch read once and each output written once.
Operations: :func:`flops_per_interface` (counted by hand from the plain
formulas) for every interface, and for the fused update of B2 80 operations
a cell (MHD; 40 Euler).  Both against the published peaks of one H100 SXM at
its full 700 W (NVIDIA's data sheet); the card's power limit is reported
beside every share.

The configuration is the reference package's that the file names
(``problems.reference_of``), and its ``eqn``, ``solver``, ``av`` and
``coords`` are compared by value, so a reference with constants of its own
is counted the same way.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67.0e12, "float64": 34.0e12}
# rows of the radial axis's geometry pack (``fused_sweep.radial_geo``), over
# the padded cells, that B1 and B2 stage beside the state on a cylindrical
# grid's axis 0
GEO_ROWS = 6


def _v(member) -> str:
    """An enumeration member's value (a plain string passes through)."""
    return getattr(member, "value", member)


def _kernel_solver(cfg) -> str:
    """The solver the kernels compute for ``cfg``: its own, but ``roe_pv``
    for MHD and GLM-MHD is the linear solver."""
    if _v(cfg.solver) == "roe_pv" and cfg.eqn.is_mhd:
        return "linear"
    return _v(cfg.solver)


def _uses_mask(cfg) -> bool:
    """Whether the kernels read the HLLD->HLL fallback mask."""
    return (_v(cfg.solver) == "hlld" and cfg.eqn.is_mhd
            and cfg.hlld_fallback)


# Operations of one interface's Riemann solve, by (Euler?, solver), counted
# by hand from the formulas of the plain version (an add, multiply, divide,
# square root, compare-and-select each count one).  Each includes what the
# solver itself needs of the two sides (conserved states, fluxes, sound or
# fast speeds); the MHD HLL and HLLD rows share 161 of them (prim_to_cons
# 2 x 27, flux_from_pu 2 x 33, fast speeds 2 x 18, wave speeds 5).
_SOLVE_FLOPS = {
    # Euler: both sides' U and flux 2 x 18; speeds 11; mid flux 35, selects
    # 10, ustar 30, cons_to_prim with floors 17
    (True, "hll"): 139,
    # linear_pv: arithmetic means, p*, v*, rho*, the sampling selects, and
    # flux_from_prim of the sampled state (18)
    (True, "linear"): 71,
    # roe_cv: Roe averages and enthalpies 54, both sides' U 24, strengths 32,
    # eigenvector entries 7, both fluxes 41, 5 waves x 12 of dissipation, p
    (True, "roe"): 229,
    # roe_pv: roe_average_state 48, the enthalpy mean again 24, a 13, p* v*
    # rho* 32, sampling 16, flux_from_prim 18
    (True, "roe_pv"): 146,
    (False, "hll"): 161 + 8 + 8 * 11,
    # star 30, two outer stars 2 x 62, Alfven speeds 10, double star 45,
    # 2 x 16, assembly 8 x 7
    (False, "hlld"): 161 + 30 + 2 * 62 + 10 + 45 + 2 * 16 + 8 * 7,
    # linear: means and betas 35, speeds 50, jumps 10, strengths 91,
    # eigenvectors 66, P* from the left 154 and from the right 178, floors,
    # flux_from_prim and prim_to_cons of P* 87
    (False, "linear"): 673,
    # roe_cv: Roe averages 24, both sides' U 54, enthalpies 22, jumps and X
    # and dp 42, speeds 65, strengths 81, eigenvectors 144, both fluxes 128,
    # 7 waves x 16 of dissipation, U of the Roe mean 29
    (False, "roe"): 725,
}


def flops_per_interface(cfg, order: int) -> int:
    """Floating-point operations of one interface solve and its share of
    the cell update on a Cartesian axis, counted by hand from the formulas
    of the plain version (an add, multiply, divide, square root,
    compare-and-select each count one)."""
    nb = cfg.eqn.nbase
    euler = _v(cfg.eqn) == "euler"
    n = 0
    if order == 2:
        n += cfg.nvar * 29          # 3 differences/dx, 2 limiters, 2 edges
    n += _SOLVE_FLOPS[(euler, _kernel_solver(cfg))]
    if _uses_mask(cfg):
        n += 8 + 8 * 11             # the HLL fallback of flagged interfaces
    if _v(cfg.eqn) == "glm":
        n += 14
    if _v(cfg.av) == "falle":
        # Euler: sound speed of p*, 3 momenta, energy; MHD: fast speed of
        # the mean, momenta and transverse field of the slim star
        n += 21 if euler else 5 + 18 + 2 + 3 * 5 + 1 + 2 * 5 + 1
    n += cfg.ntracer * 6
    # divergence and dt; MHD also the Powell and GLM sources
    n += nb * 3 + (5 if euler else 24)
    return n


def _launch(cfg, axis: int, order: int, final: bool):
    """(bytes, operations) of one B1 launch on ``axis`` (a contribution
    written) or of B2 (``final``: the last axis's contribution and the
    update; it reads the state, the padded state and the other axes'
    contributions and writes the new state).  On a cylindrical grid's
    radial axis (0) each also reads the geometry pack."""
    esz = np.dtype(cfg.dtype).itemsize
    cells = int(np.prod(cfg.shape))
    padded = int(np.prod([n + 2 * cfg.ng for n in cfg.shape]))
    mask = cells if _uses_mask(cfg) else 0
    common = padded * cfg.nvar * esz + mask + 2 * esz
    if axis == 0 and _v(cfg.coords) == "cylindrical":
        common += GEO_ROWS * (cfg.shape[0] + 2 * cfg.ng) * esz
    interfaces = cells // cfg.shape[axis] * (cfg.shape[axis] + 1)
    flops = interfaces * flops_per_interface(cfg, order)
    if not final:
        return common + cfg.nvar * cells * esz, flops
    others = cfg.ndim - 1
    update = (40 if _v(cfg.eqn) == "euler" else 80) * cells
    return common + (2 + others) * cfg.nvar * cells * esz, flops + update


def sweep_launches(config: dict) -> list:
    """(bytes, operations) of each fused-sweep launch of one step: on one
    grid, a predictor and a corrector of B1 on every axis but 0 and B2 on
    axis 0; on a hierarchy, each level-advance (2^l a level) B1 on every
    axis at both orders (its update is plain)."""
    from bench_port.problems import reference_of, sim_config

    cfg = sim_config(reference_of(config), config, kernels="off")
    out = []
    if cfg.nlevels == 1:
        for order in (1, 2):
            out += [_launch(cfg, a, order, False) for a in range(1, cfg.ndim)]
            out.append(_launch(cfg, 0, order, True))
        return out
    advances = sum(2 ** l for l in range(cfg.nlevels))
    for order in (1, 2):
        out += [_launch(cfg, a, order, False) for a in range(cfg.ndim)]
    return out * advances


def least_s(launches: list, dtype: str) -> float:
    """The least time of ``launches``: each at the larger of its bytes over
    the memory rate and its operations over the peak rate."""
    return sum(max(b / PEAK_BYTES_PER_S, f / PEAK_FLOPS[dtype])
               for b, f in launches)

