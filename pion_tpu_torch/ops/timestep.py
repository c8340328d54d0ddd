"""CFL timestep calculation.

Vectorized equivalent of the per-cell ``CellTimeStep`` loop
(reference: source/sim_control/calc_timestep.cpp:271-340 calc_dynamics_dt;
source/spatial_solvers/solver_eqn_hydro_adi.cpp:460-502 for hydro,
solver_eqn_mhd_adi.cpp:516-582 for MHD).
"""
from __future__ import annotations

import torch

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO, VX, Eqn
from ..grid import Geometry
from .eqns import cfast_components, sound_speed


def max_signal_speed(P: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Per-cell maximum signal speed.

    Hydro: |v| (norm over active dims) + sound speed
    (reference: solver_eqn_hydro_adi.cpp:473-476).
    MHD: max component |v_i| + fast speed along the weakest-field direction
    (the rotation hunt at solver_eqn_mhd_adi.cpp:541-564 picks the axis with
    the smallest |B| because c_f is maximal there).
    """
    if cfg.eqn is Eqn.EULER:
        v2 = sum(P[VX + i] ** 2 for i in range(cfg.ndim))
        return torch.sqrt(v2) + sound_speed(P, cfg)
    vmax = torch.abs(P[VX])
    for i in range(1, cfg.ndim):
        vmax = torch.maximum(vmax, torch.abs(P[VX + i]))
    if cfg.ndim == 1:
        bn = P[BX]
    else:
        bn = torch.minimum(torch.minimum(torch.abs(P[BX]), torch.abs(P[BY])),
                           torch.abs(P[BZ]))
    # cfast depends on bn^2 and the total B^2; feed the remainder through by.
    b2 = P[BX] ** 2 + P[BY] ** 2 + P[BZ] ** 2
    bt = torch.sqrt(torch.clamp(b2 - bn * bn, min=0.0))
    cf = cfast_components(P[RO], P[PG], bn, bt, torch.zeros_like(bt), cfg.gamma)
    return vmax + cf


def dynamics_dt(P: torch.Tensor, cfg: SimConfig, geom: Geometry,
                exclude=None) -> torch.Tensor:
    """Global CFL-limited dynamical timestep (0-d tensor on P's device; it
    is not read back here).

    ``exclude``: boolean mask of cells left out of the reduction — the
    reference skips internal-boundary (stellar-wind) cells, whose state
    is overwritten every step and whose floor-density Alfven speed would
    otherwise throttle dt by ~1e3x (calc_timestep.cpp "c->timestep &&
    !c->isbd")."""
    speed = max_signal_speed(P, cfg)
    if exclude is not None:
        speed = torch.where(exclude, 0.0, speed)
    return cfg.cfl * geom.dx / torch.max(speed)
