"""External boundary conditions as pure pad functions.

The reference implements each BC as an assign/update class pair operating on
ghost-cell linked lists (reference: source/boundaries/*_boundaries.cpp,
orchestrated by assign_update_bcs.cpp).  Here a boundary condition is simply
a rule for filling the ``ng`` ghost layers while padding the state tensor —
``apply_bcs`` maps ``(nvar, *shape) -> (nvar, *(shape+2*ng))`` and returns a
new tensor; the state it is given is never written.

Sign conventions for mirror-type BCs follow the reference exactly:
  - reflecting: negate normal v and normal B (reflecting_boundaries.cpp:36-76)
  - jetreflect: negate normal v and TANGENTIAL B (jetreflect_boundaries.cpp:50-66)
  - axisymmetric (R=0): negate v_R, v_theta, B_R, B_theta
    (axisymmetric_boundaries.cpp:40-57)

Ported kinds: periodic, outflow, oneway_out, reflecting, jetreflect,
axisymmetric, inflow, fixed.  The double-Mach-reflection and jet faces
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import SimConfig
from .constants import BC, BX, BY, BZ, VX, VY, VZ


@dataclasses.dataclass(frozen=True)
class BoundaryData:
    """Static per-face data for value-carrying BCs.

    ``fixed[(axis, side)]`` holds a ghost-strip numpy array of shape
    (nvar, ..., ng, ...) — the frozen inflow/fixed state for that face
    (reference: inflow_boundaries.cpp / fixed_boundaries.cpp store refval).
    ``jet`` optionally holds (radius_physical, state_vector) for a jet
    inflow region on a BC.JET face (reference: jet_boundaries.cpp); the
    field is carried, the BC kind itself is not ported yet.
    """

    fixed: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(default_factory=dict)
    jet: Optional[Tuple[float, np.ndarray]] = None
    # strips already cast to a (dtype, device), so a step copies nothing
    # from the host
    _strips: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def __hash__(self):
        return hash(
            (
                tuple(sorted((k, v.tobytes()) for k, v in self.fixed.items())),
                None
                if self.jet is None
                else (self.jet[0], self.jet[1].tobytes()),
            )
        )

    def __eq__(self, other):
        return isinstance(other, BoundaryData) and hash(self) == hash(other)

    def strip(self, axis: int, side: int, like: torch.Tensor):
        """The frozen strip of one face as a tensor like ``like`` (dtype and
        device), or None when the face has none."""
        arr = self.fixed.get((axis, side))
        if arr is None:
            return None
        key = (axis, side, like.dtype, str(like.device))
        if key not in self._strips:
            self._strips[key] = torch.as_tensor(arr).to(
                dtype=like.dtype, device=like.device)
        return self._strips[key]


def _mirror_signs(cfg: SimConfig, axis: int, kind: BC) -> np.ndarray:
    """Per-variable sign multipliers for mirror-type ghost cells."""
    sg = np.ones(cfg.nvar)
    k = cfg.ndim - 1 - axis  # physical axis index (x=0 is last array axis)
    if kind in (BC.REFLECTING, BC.JETREFLECT):
        sg[VX + k] = -1.0
        if cfg.eqn.is_mhd:
            if kind is BC.REFLECTING:
                sg[BX + k] = -1.0
            else:  # jetreflect: tangential B reversed
                for j in range(3):
                    if j != k:
                        sg[BX + j] = -1.0
    elif kind is BC.AXISYMMETRIC:
        # 2D (R,z): radial = VY, theta = VZ in PION's slot convention
        sg[VY] = -1.0
        sg[VZ] = -1.0
        if cfg.eqn.is_mhd:
            sg[BY] = -1.0
            sg[BZ] = -1.0
    return sg


def _pad_axis(P, cfg: SimConfig, axis: int, bdata: BoundaryData, t=0.0):
    """Pad one spatial axis with ng ghost layers on each side."""
    ng = cfg.ng
    lo_bc, hi_bc = cfg.bcs[axis]
    ax = 1 + axis  # tensor axis (variable index leads)
    k = cfg.ndim - 1 - axis

    n = P.shape[ax]

    def slab(lo, hi):
        return P.narrow(ax, lo, hi - lo)

    def mirror(side: int, kind: BC):
        strip = torch.flip(
            slab(0, ng) if side == 0 else slab(n - ng, n), dims=(ax,))
        # the signs are exactly +-1: negate whole variables rather than
        # multiply by a sign tensor that would have to be copied over
        sg = _mirror_signs(cfg, axis, kind)
        return torch.stack([-strip[v] if sg[v] < 0.0 else strip[v]
                            for v in range(cfg.nvar)])

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
        if kind in (BC.REFLECTING, BC.JETREFLECT, BC.AXISYMMETRIC):
            return mirror(side, kind)
        if kind in (BC.INFLOW, BC.FIXED):
            strip = bdata.strip(axis, side, P)
            if strip is None:
                raise ValueError(
                    f"{kind} BC on axis {axis} side {side} needs BoundaryData.fixed"
                )
            return strip
        raise NotImplementedError(f"BC {kind} not implemented yet")

    lo = ghost(0, lo_bc)
    hi = ghost(1, hi_bc)
    return torch.cat([lo, P, hi], dim=ax)


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


def fill_ghost_side(padded, cfg: SimConfig, axis: int, side: int,
                    strip=None, t: float = 0.0):
    """Overwrite the ``ng`` ghost layers on ONE face of an already fully
    padded tensor with that face's domain BC, reading the adjacent interior
    layers.  Used by the nested-grid hierarchy for fine-level faces that
    coincide with the root domain boundary (reference: setup_NG_grid
    assigns the simulation BC there, other faces get COARSE_TO_FINE —
    grid/setup_NG_grid.cpp:205-260).  Returns a new tensor; ``padded`` is
    not written.

    ``strip`` supplies the frozen ghost state for INFLOW/FIXED faces
    (full padded transverse shape).
    """
    ng = cfg.ng
    ax = 1 + axis
    kind = cfg.bcs[axis][side]
    k = cfg.ndim - 1 - axis
    n_tot = padded.shape[ax]

    def slab(lo, hi):
        return padded.narrow(ax, lo, hi - lo)

    if kind in (BC.REFLECTING, BC.JETREFLECT, BC.AXISYMMETRIC):
        sg = _mirror_signs(cfg, axis, kind)
        src = torch.flip(slab(ng, 2 * ng) if side == 0
                         else slab(n_tot - 2 * ng, n_tot - ng), dims=(ax,))
        val = torch.stack([-src[v] if sg[v] < 0.0 else src[v]
                           for v in range(cfg.nvar)])
    elif kind in (BC.OUTFLOW, BC.ONEWAY_OUT):
        edge = slab(ng, ng + 1) if side == 0 else slab(n_tot - ng - 1,
                                                       n_tot - ng)
        val = edge.expand(edge.shape[:ax] + (ng,) + edge.shape[ax + 1:])
        if kind is BC.ONEWAY_OUT:
            vslot = VX + k
            vn = val[vslot]
            vn = (torch.clamp(vn, max=0.0) if side == 0
                  else torch.clamp(vn, min=0.0))
            val = torch.stack([vn if v == vslot else val[v]
                               for v in range(cfg.nvar)])
    elif kind in (BC.INFLOW, BC.FIXED):
        if strip is None:
            raise ValueError(f"{kind} on a refined level needs a frozen "
                             "ghost strip (captured at hierarchy setup)")
        val = torch.as_tensor(strip).to(dtype=padded.dtype,
                                        device=padded.device)
    else:
        raise NotImplementedError(
            f"BC {kind} unsupported on a refined-level domain face")
    tgt = [slice(None)] * padded.ndim
    tgt[ax] = slice(0, ng) if side == 0 else slice(n_tot - ng, n_tot)
    out = padded.clone()
    out[tuple(tgt)] = val
    return out


def apply_bcs_outflow_only(P, cfg: SimConfig):
    """Pad every face with outflow ghosts (helper for strip capture)."""
    out = torch.as_tensor(P)
    ng = cfg.ng
    for axis in range(cfg.ndim):
        ax = 1 + axis
        n = out.shape[ax]
        lo = out.narrow(ax, 0, 1)
        hi = out.narrow(ax, n - 1, 1)
        lo = lo.expand(lo.shape[:ax] + (ng,) + lo.shape[ax + 1:])
        hi = hi.expand(hi.shape[:ax] + (ng,) + hi.shape[ax + 1:])
        out = torch.cat([lo, out, hi], dim=ax)
    return out
