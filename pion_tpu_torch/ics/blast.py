"""Blast-wave initial conditions (1D-spherical, 2D, 3D; hydro or MHD).

Reference: source/ics/blastwave.cpp — over-pressured central region in a
uniform ambient medium.
"""
from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..constants import BX, BY, BZ, PG, RO
from ..grid import make_geometry


def blast_wave(
    cfg: SimConfig,
    rho0: float = 1.0,
    p0: float = 0.1,
    p_in: float = 10.0,
    r_in: float = 0.1,
    center=None,
    B0=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Uniform medium with pressure ``p_in`` inside radius ``r_in``."""
    geom = make_geometry(cfg)
    ng = cfg.ng
    coords = [g.pos[ng:-ng] for g in geom.axes]
    if center is None:
        center = [0.5 * (cfg.xmin[i] + cfg.xmax[i]) for i in range(cfg.ndim)]
        if cfg.coords.value != "cartesian":
            center = [0.0] * cfg.ndim
    grids = np.meshgrid(*coords, indexing="ij")
    r2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    P = np.zeros((cfg.nvar,) + cfg.shape)
    P[RO] = rho0
    P[PG] = np.where(r2 <= r_in * r_in, p_in, p0)
    if cfg.eqn.is_mhd:
        P[BX], P[BY], P[BZ] = B0[0], B0[1], B0[2]
    return P
