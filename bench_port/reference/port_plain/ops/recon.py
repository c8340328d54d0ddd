"""MUSCL reconstruction: limited slopes and edge states.

Vectorized counterpart of the reference's per-cell slope/edge machinery
(reference: source/coord_sys/VectorOps.cpp:535-617 for Cartesian,
:1052-1202 for cylindrical; limiter AvgFalle at VectorOps.cpp:40-59).

``limited_slopes`` operates on a tensor whose SWEEP AXIS IS LAST; the caller
is responsible for moving the padded state's axis there.
"""
from __future__ import annotations

import torch

# underflows to 0 in float32, so the test below is ``prod > 0`` there
VERY_TINY = 1.0e-200


def van_albada(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Falle/van Albada slope average (reference: VectorOps.cpp:40-59).

    Returns 0 when the one-sided slopes have opposite signs or are tiny,
    else ``a*b*(a+b)/(a^2+b^2)``.
    """
    prod = a * b
    denom = a * a + b * b
    safe = torch.where(denom > 0.0, denom, 1.0)
    return torch.where(prod > VERY_TINY, prod * (a + b) / safe, 0.0)


def limited_slopes(Ppad: torch.Tensor, com: torch.Tensor) -> torch.Tensor:
    """Van Albada-limited slope for every cell that has both neighbours.

    Ppad: (nvar, ..., Npad) with the sweep axis last; com: (Npad,) the
    center-of-volume coordinates along the sweep axis (uniform dx for
    Cartesian, R_com for radial axes — reference VectorOps.cpp:1150-1165).
    Returns slopes of shape (nvar, ..., Npad-2) for cells [1, Npad-1).
    """
    d = Ppad[..., 1:] - Ppad[..., :-1]          # (nvar, ..., Npad-1)
    h = com[1:] - com[:-1]
    one_sided = d / h
    return van_albada(one_sided[..., :-1], one_sided[..., 1:])


def edge_states(
    Pc: torch.Tensor,
    slope: torch.Tensor,
    del_n: torch.Tensor,
    del_p: torch.Tensor,
):
    """Edge states at the low/high faces of each cell.

    ``Pc`` are the cell values matching ``slope``; ``del_n``/``del_p`` are the
    signed offsets from the center-of-volume to the low/high face (±dx/2 on a
    Cartesian axis; face-position − R_com on a radial axis — reference
    VectorOps.cpp:1052-1092).  Returns ``(P_lo_face, P_hi_face)``.
    """
    return Pc + slope * del_n, Pc + slope * del_p
