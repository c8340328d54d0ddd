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

The double-Mach-reflection (DMACH, DMACH2) and jet faces select between
two states per ghost cell; their masks and states are geometry, made once
per dtype and device and kept in the ``BoundaryData``, so that a CUDA graph
that records a step keeps valid pointers.  The DMACH ghosts move with the
time ``t`` a step passes, a number or (inside a chunk) a float64 0-d tensor
on the state's device: the shock position is formed by tensor operations on
it, never read back.
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
    inflow region on a BC.JET face (reference: jet_boundaries.cpp: inflow
    within JP.jetradius of the axis, reflecting outside).
    """

    fixed: Dict[Tuple[int, int], np.ndarray] = dataclasses.field(default_factory=dict)
    jet: Optional[Tuple[float, np.ndarray]] = None
    # a block of a sharded grid: the whole grid's config and the block's
    # first global cell along every axis, from which its faces take their
    # positions (see block); None for a whole grid
    whole: Optional[Tuple[SimConfig, Tuple[int, ...]]] = dataclasses.field(
        default=None, compare=False)
    # strips, masks and states already on a (dtype, device), so a step
    # copies nothing from the host
    _tensors: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

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

    def block(self, cfg: SimConfig, ranges) -> "BoundaryData":
        """This data for one block of a sharded grid of config ``cfg``
        (``ranges``: the block's global index range along every axis): the
        frozen strips sliced to the block's span of the axes across each
        face (its ghosts on the axes padded before that face's, as
        :func:`apply_bcs` pads them), and the whole grid's config and the
        block's origin, from which the DMACH/DMACH2/JET faces take their
        cell positions."""
        ng = cfg.ng
        fixed = {}
        for (axis, side), arr in self.fixed.items():
            sl = [slice(None)]
            for bx, (lo, hi) in enumerate(ranges):
                sl.append(slice(None) if bx == axis else
                          slice(lo, hi + 2 * ng) if bx < axis else
                          slice(lo, hi))
            fixed[(axis, side)] = np.ascontiguousarray(arr[tuple(sl)])
        return BoundaryData(fixed=fixed, jet=self.jet,
                            whole=(cfg, tuple(lo for lo, _ in ranges)))

    def positions(self, cfg: SimConfig, axis: int, n: int,
                  padded: bool = False) -> np.ndarray:
        """The cell centres along ``axis`` of the grid (or block) of ``n``
        cells there whose faces this data fills: the whole grid's centres,
        sliced to the block."""
        if self.whole is None:
            return cfg.cell_centers(axis, padded=padded)
        whole, origin = self.whole
        lo = origin[axis]
        return whole.cell_centers(axis, padded=padded)[
            lo:lo + n + (2 * cfg.ng if padded else 0)]

    def strip(self, axis: int, side: int, like: torch.Tensor):
        """The frozen strip of one face as a tensor like ``like`` (dtype and
        device), or None when the face has none."""
        arr = self.fixed.get((axis, side))
        if arr is None:
            return None
        return self.kept((axis, side), like, lambda: arr)

    def kept(self, name, like: torch.Tensor, make, dtype=None):
        """``make()`` (a numpy array) as a tensor on ``like``'s device, of
        ``dtype`` or ``like``'s; made at the first call for each name,
        dtype and device and kept."""
        dtype = like.dtype if dtype is None else dtype
        key = (name, dtype, str(like.device))
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(make()).to(
                dtype=dtype, device=like.device)
        return self._tensors[key]


# Double-Mach-reflection states (reference:
# double_Mach_ref_boundaries.cpp:39-44 pre-shock, :189-194 post-shock).
DMR_POST = (8.0, 116.5, 7.14470958, -4.125, 0.0)
DMR_PRE = (1.4, 1.0, 0.0, 0.0, 0.0)
# sin and tan of 60 degrees as numpy gives them, the JAX package's factors
_SIN60 = float(np.sin(np.pi / 3.0))
_TAN60 = float(np.tan(np.pi / 3.0))


def _dmr_states(cfg: SimConfig, bdata: BoundaryData, like):
    """The post- and pre-shock state vectors, ``(nvar, 1, 1)`` like
    ``like``; a tracer is 1 behind the shock and -1 ahead of it."""
    def vec(state, tr):
        return lambda: np.array([state[v] if v < 5 else tr
                                 for v in range(cfg.nvar)]).reshape(-1, 1, 1)

    return (bdata.kept("dmr_post", like, vec(DMR_POST, 1.0)),
            bdata.kept("dmr_pre", like, vec(DMR_PRE, -1.0)))


def _dmr_state(cfg: SimConfig, bdata: BoundaryData, like, t):
    """The DMACH ghost strip ``(nvar, ng, nx)``: post- or pre-shock by the
    oblique shock position x_s(y,t) = 10 t/sin(60deg) + 1/6 + y/tan(60deg)
    (reference: double_Mach_ref_boundaries.cpp:184-198), compared in
    float64 at the cell centres (x as the config's dtype holds them) and
    the ghost rows above the domain."""
    ng = cfg.ng
    top = cfg.xmax[0] if bdata.whole is None else bdata.whole[0].xmax[0]
    x = bdata.kept("dmr_x", like, lambda: bdata.positions(
        cfg, 1, like.shape[-1])[None, :], dtype=torch.float64)
    y = bdata.kept("dmr_y", like, lambda: (
        top + (np.arange(ng) + 0.5) * cfg.dx)[:, None],
        dtype=torch.float64)
    bpos = 10.0 * t / _SIN60 + 1.0 / 6.0 + y / _TAN60
    post, pre = _dmr_states(cfg, bdata, like)
    return torch.where(x <= bpos, post, pre)


def _jet_mask(cfg: SimConfig, radius: float, bdata: "BoundaryData",
              shape) -> np.ndarray:
    """Ghost cells of the JET face (the low face of the last axis) within
    ``radius`` of the jet axis, over the padded transverse axes: in 2D the
    distance from the symmetry axis (the first axis, Cartesian or
    cylindrical R), in 3D from the domain's centre line.  Distances and the
    comparison in the config's dtype, as the JAX package forms them (its
    ``jnp.hypot`` written out).  ``shape``: the grid's (or block's) cells
    along every axis, the transverse ones already padded; a block takes
    the whole grid's positions (``bdata.positions``) and centre line."""
    whole = cfg if bdata.whole is None else bdata.whole[0]
    ng = cfg.ng

    def centres(axis):
        return bdata.positions(cfg, axis, shape[axis] - 2 * ng, padded=True)

    if cfg.ndim == 2:
        return (np.abs(centres(0)) < radius)[None, :, None]
    yy = centres(1)
    zz = centres(0)
    a = np.abs(zz[:, None] - 0.5 * (whole.xmin[0] + whole.xmax[0]))
    b = np.abs(yy[None, :] - 0.5 * (whole.xmin[1] + whole.xmax[1]))
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    q = lo / np.where(hi == 0, np.ones_like(hi), hi)
    rdist = np.where(hi == 0, hi, hi * np.sqrt(1 + q * q))
    return (rdist < radius)[None, :, :, None]


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
        if kind is BC.DMACH:
            # time-dependent oblique-shock top boundary of the double-Mach
            # reflection problem (reference: double_Mach_ref_boundaries.cpp
            # BC_update_DMACH:169-200)
            if not (cfg.ndim == 2 and axis == 0 and side == 1):
                raise ValueError("a DMACH face is the high face of axis 0 "
                                 "of a 2D grid")
            return _dmr_state(cfg, bdata, P, t)
        if kind is BC.DMACH2:
            # fixed post-shock wedge x < 1/6 on the bottom wall, reflecting
            # beyond (reference: :100-160)
            if not (cfg.ndim == 2 and axis == 0 and side == 0):
                raise ValueError("a DMACH2 face is the low face of axis 0 "
                                 "of a 2D grid")
            wedge = bdata.kept("dmr_wedge", P, lambda: (
                bdata.positions(cfg, 1, P.shape[-1]).astype(np.float64)
                < 1.0 / 6.0)[None, None, :], dtype=torch.bool)
            post = bdata.kept("dmr_wedge_post", P, lambda: np.array(
                list(DMR_POST) + [1.0] * cfg.ntracer).reshape(-1, 1, 1))
            return torch.where(wedge, post, mirror(side, BC.REFLECTING))
        if kind is BC.JET:
            # jet inflow within `radius` of the symmetry axis, reflecting
            # outside (reference: jet_boundaries.cpp); the jet flows along
            # +x, so the face is the LAST axis' low side
            if not (axis == cfg.ndim - 1 and side == 0 and cfg.ndim > 1):
                raise ValueError("a JET face is the low face of the last "
                                 "axis of a 2D or 3D grid")
            if bdata.jet is None:
                raise ValueError("a JET BC needs BoundaryData.jet")
            radius, jstate = bdata.jet
            inside = bdata.kept("jet_mask", P,
                                lambda: _jet_mask(cfg, radius, bdata,
                                                  P.shape[1:]),
                                dtype=torch.bool)
            js = bdata.kept("jet_state", P, lambda: np.asarray(
                jstate, dtype=np.float64).reshape((-1,) + (1,) * cfg.ndim))
            return torch.where(inside, js, mirror(side, BC.REFLECTING))
        raise NotImplementedError(f"BC {kind} not implemented")

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
    (full padded transverse shape).  The double-Mach-reflection and jet
    faces raise ``NotImplementedError`` on a refined level, as they do in
    the JAX package (``pion_tpu/boundaries.py:277-278``).
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
