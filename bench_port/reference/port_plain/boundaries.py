"""External boundary conditions as pure pad functions.

The reference implements each BC as an assign/update class pair operating on
ghost-cell linked lists (reference: source/boundaries/*_boundaries.cpp,
orchestrated by assign_update_bcs.cpp).  Here a boundary condition is simply
a rule for filling the ``ng`` ghost layers while padding the state tensor —
``apply_bcs`` maps ``(nvar, *shape) -> (nvar, *(shape+2*ng))`` and returns a
new tensor; the state it is given is never written.

Kept in this copy: periodic, outflow, one-way outflow, inflow and fixed
faces.  The mirror-type, double-Mach-reflection and jet faces are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import SimConfig
from .constants import BC, VX


@dataclasses.dataclass(frozen=True)
class BoundaryData:
    """Static per-face data for value-carrying BCs.

    ``fixed[(axis, side)]`` holds a ghost-strip numpy array of shape
    (nvar, ..., ng, ...) — the frozen inflow/fixed state for that face
    (reference: inflow_boundaries.cpp / fixed_boundaries.cpp store refval).
    """

    fixed: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(default_factory=dict)
    # strips already on a (dtype, device), so a step copies nothing from the
    # host
    _tensors: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def strip(self, axis: int, side: int, like: torch.Tensor):
        """The frozen strip of one face as a tensor like ``like`` (dtype and
        device), or None when the face has none."""
        arr = self.fixed.get((axis, side))
        if arr is None:
            return None
        key = ((axis, side), like.dtype, str(like.device))
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(arr).to(
                dtype=like.dtype, device=like.device)
        return self._tensors[key]


def _pad_axis(P, cfg: SimConfig, axis: int, bdata: BoundaryData, t=0.0):
    """Pad one spatial axis with ng ghost layers on each side."""
    lo, hi = axis_ghosts(P, cfg, axis, bdata, t=t)
    return torch.cat([lo, P, hi], dim=1 + axis)


def axis_ghosts(P, cfg: SimConfig, axis: int, bdata: BoundaryData, t=0.0):
    """The ``ng`` ghost layers of the low and of the high face of one
    spatial axis, from the domain BCs and ``P``'s edge data."""
    ng = cfg.ng
    lo_bc, hi_bc = cfg.bcs[axis]
    ax = 1 + axis  # tensor axis (variable index leads)
    k = cfg.ndim - 1 - axis

    n = P.shape[ax]

    def slab(lo, hi):
        return P.narrow(ax, lo, hi - lo)

    def ghost(side: int, kind: BC):
        # side: 0 = low face, 1 = high face; returns ng-layer strip ordered
        # outermost..innermost for lo, innermost..outermost for hi.
        if kind is BC.PERIODIC:
            return slab(n - ng, n) if side == 0 else slab(0, ng)
        if kind in (BC.OUTFLOW, BC.ONEWAY_OUT):
            edge = slab(0, 1) if side == 0 else slab(n - 1, n)
            edge = edge.expand(
                edge.shape[:ax] + (ng,) + edge.shape[ax + 1:])
            if kind is BC.ONEWAY_OUT:
                # clip inflow normal velocity to zero
                # (reference: oneway_out_boundaries.cpp:38-100)
                vslot = VX + k
                vn = edge[vslot]
                vn = (torch.clamp(vn, max=0.0) if side == 0
                      else torch.clamp(vn, min=0.0))
                edge = torch.stack([vn if v == vslot else edge[v]
                                    for v in range(cfg.nvar)])
            return edge
        if kind in (BC.INFLOW, BC.FIXED):
            strip = bdata.strip(axis, side, P)
            if strip is None:
                raise ValueError(
                    f"{kind} BC on axis {axis} side {side} needs BoundaryData.fixed"
                )
            return strip
        raise NotImplementedError(f"BC {kind}: left out of this copy")

    return ghost(0, lo_bc), ghost(1, hi_bc)


def apply_bcs(P, cfg: SimConfig, bdata: Optional[BoundaryData] = None, t=0.0):
    """Pad all axes with BC-filled ghost zones (slowest axis first, so corner
    ghosts are filled from already-padded transverse data, matching the
    reference's sequential boundary updates)."""
    if bdata is None:
        bdata = BoundaryData()
    out = P
    for axis in range(cfg.ndim):
        out = _pad_axis(out, cfg, axis, bdata, t=t)
    return out


def make_fixed_strips(P0, cfg: SimConfig) -> BoundaryData:
    """Capture the initial edge states for INFLOW/FIXED faces
    (reference: inflow_boundaries.cpp BC_assign_INFLOW uses the IC edge
    value).  ``P0`` is the initial state as a numpy array."""
    ng = cfg.ng
    fixed = {}
    # Mimic apply_bcs' sequential padding: when axis a is padded, axes < a
    # are already padded and axes > a are not — strips must match that shape.
    out = np.asarray(P0)
    for axis in range(cfg.ndim):
        ax = 1 + axis
        n = out.shape[ax]
        lo = np.take(out, [0] * ng, axis=ax)
        hi = np.take(out, [n - 1] * ng, axis=ax)
        for side, kind in enumerate(cfg.bcs[axis]):
            if kind in (BC.INFLOW, BC.FIXED):
                fixed[(axis, side)] = (lo if side == 0 else hi).copy()
        out = np.concatenate([lo, out, hi], axis=ax)
    return BoundaryData(fixed=fixed)
