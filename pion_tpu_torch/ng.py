"""Static nested-grid (NG) refinement with Berger-Colella flux correction.

Counterpart of the reference NG machinery
(reference: source/grid/setup_NG_grid.cpp:88-160 level extents about
NG_centre; source/sim_control/sim_control_NG.cpp:564-810 recursive
advance_step_OA1/OA2; source/boundaries/NG_coarse_to_fine_boundaries.cpp
slope-limited prolongation; NG_fine_to_coarse_boundaries.cpp:255-320
volume-weighted conserved restriction; NG_BC89flux.cpp Berger & Colella
1989 flux summation).

Structure: a stack of levels, each 2x finer with the SAME cell count,
nested about ``ng_centre`` (snapped to i/4 of the domain per axis, like
setup_NG_grid_levels), advanced depth-first with two fine steps per coarse
step.  Each level is a dense tensor + per-level geometry; C2F ghost filling
is a slice + repeat + limited-slope prolongation, F2C is a volume-weighted
conservative average (exact in cylindrical/spherical coords), and BC89
replaces the coarse flux at fine-boundary faces with the area-weighted
time-averaged sum of fine fluxes.  Fine-level faces that coincide with the
root domain boundary apply the domain BC instead of C2F (reference:
setup_NG_grid.cpp:205-260).

The methods run eagerly, one PyTorch or CUDA launch after another.  ``dt``,
the cleaning speed ``ch`` of each level and the half steps stay 0-d tensors
on the device through the whole recursion; a step reads one number back,
the ``dt`` it took.  ``run(chunk=k)`` takes k steps at a time with the dt
policy on the device, as one CUDA graph replay on the card
(:mod:`.graphs`), and reads back once a chunk.  No method writes into a
state it was given: the corrector reads the start-of-step state again after
the predictor, both child substeps read the parent's half-step state, and
the restriction reads the child after both.  The only in-place write is the BC89 addition
into the corrector's own fresh ``dU``.

Prolongation, restriction, BC89 and the interface slabs are plain PyTorch;
each level's sweeps go through the fused CUDA kernels under the rule of
``SimConfig.kernels``.

On a mesh of shards (ROADMAP A20.4) every level is split over the same
mesh, as the JAX package puts every level on one mesh: each level is a
:class:`.parallel.mesh.Sharded` and steps block by block (the per-shard
side of ``stepper._Shards``, one a level).  A fine block's ghosts come from
its neighbours (the exchange), from the parent's box around its window on
the level's outer faces (:func:`.parallel.mesh.region`, prolonged as on
one device) and from the domain BC on root-domain faces; the restriction
and BC89 write into whichever parent blocks hold the cells
(:func:`.parallel.mesh.write_regions`); each cell takes the one-device
value.  ``run(chunk=k)`` on a mesh selects the levels block by block; where
every shard lies on one card a chunk is one CUDA graph, over several
devices it runs eagerly.  On a mesh of several processes each process
steps its own blocks of every level, and the glue's boxes, strips and
planes go between the processes through :mod:`.parallel.comm` (the
parent's window to the ranks on the level's outer boundary, the fine sums
to the ranks whose parent blocks BC89 corrects); ``save`` gathers to rank
0, which alone writes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .boundaries import (apply_bcs, apply_bcs_outflow_only, fill_ghost_side,
                         make_fixed_strips)
from .config import SimConfig
from .constants import AV, BC, Coord, Eqn
from .grid import make_geometry
from .ops import fused_sweep
from .ops.eqns import cons_to_prim, prim_to_cons
from .ops.recon import van_albada
from .ops.sweep import dynamics_dU, interface_flux, interface_flux_pair
from .ops.timestep import dynamics_dt
from .parallel.halo import neighbour_strips
from .parallel.mesh import Sharded, gather, region, write_regions
from .stepper import (_on, _scma_flag, _Shards, cell_advance, glm_psi_damp,
                      later, limit_dt, select)
from .utils import StepLogger, resolve_device

def snap_ng_centre(cfg0: SimConfig) -> Tuple[float, ...]:
    """Snap the refinement centre to xmin + i/4 of the domain per axis so
    the oct-tree structure aligns with cell faces (reference:
    setup_NG_grid.cpp:93-112)."""
    out = []
    for ax in range(cfg0.ndim):
        lo, hi = cfg0.xmin[ax], cfg0.xmax[ax]
        rng = hi - lo
        c = cfg0.ng_centre[ax] if cfg0.ng_centre is not None else 0.5 * (lo + hi)
        f = 4.0 * (c - lo) / rng
        fr = f - np.floor(f)
        if not np.isclose(fr, 0.0, atol=1e-8) and not np.isclose(fr, 1.0,
                                                                 atol=1e-8):
            c = lo + np.round(f) * rng / 4.0
        out.append(float(np.clip(c, lo, hi)))
    return tuple(out)


def make_level_cfg(cfg0: SimConfig, level: int,
                   centre: Optional[Tuple[float, ...]] = None) -> SimConfig:
    """Level-l config: same cell counts, extents halved toward ``centre``
    per the reference recursion Xmin_l = (Xmin_{l-1} + centre)/2
    (reference: setup_NG_grid.cpp:142-155)."""
    if centre is None:
        centre = snap_ng_centre(cfg0)
    xmin = list(cfg0.xmin)
    xmax = list(cfg0.xmax)
    for _ in range(level):
        xmin = [0.5 * (lo + c) for lo, c in zip(xmin, centre)]
        xmax = [0.5 * (hi + c) for hi, c in zip(xmax, centre)]
    return cfg0.with_(xmin=tuple(xmin), xmax=tuple(xmax), nlevels=1,
                      ng_centre=None)


def _pairsum(a, axis):
    """Sum adjacent pairs along ``axis`` (length n -> n//2): a split of the
    axis into (n//2, 2) and a sum over the pair."""
    axis = axis % a.ndim
    sh = tuple(a.shape)
    a = a.reshape(sh[:axis] + (sh[axis] // 2, 2) + sh[axis + 1:])
    return a.sum(dim=axis + 1)


def _clamped_slice(A, axis, start, count):
    """Edge-clamped window [start, start+count) along ``axis``."""
    n = A.shape[axis]
    lo_pad = max(0, -start)
    hi_pad = max(0, start + count - n)
    core = A.narrow(axis, start + lo_pad, count - lo_pad - hi_pad)
    if not lo_pad and not hi_pad:
        return core
    parts = []
    if lo_pad:
        parts.extend([A.narrow(axis, 0, 1)] * lo_pad)
    parts.append(core)
    if hi_pad:
        parts.extend([A.narrow(axis, n - 1, 1)] * hi_pad)
    return torch.cat(parts, dim=axis)


def _upsample2_clamped(A, axis, start, count):
    """``A`` windowed to ``count`` cells from ``start`` (edge-clamped) and
    each cell repeated twice along ``axis`` — the regular stride-2 pattern
    of C2F prolongation (indices clip(start+floor(i/2))) expressed as
    slice + repeat instead of a gather."""
    return _clamped_slice(A, axis, start, count).repeat_interleave(2, dim=axis)


class NGHierarchy:
    """Holds per-level state and advances the stack recursively.

    ``device``: the CUDA device when None (raising if there is none), the
    CPU only when the caller asks for it.  ``mesh``
    (:class:`.parallel.mesh.Mesh`): every level is split over it (so it
    is when the states handed to :meth:`set_states` are sharded, or when
    ``cfg0.mesh`` asks for a mesh over several visible devices).

    The H-correction (``av`` "hcorr" / "hcorr_falle") runs on every level
    through the plain sweep, which keeps its face fluxes for BC89.
    ``cfg.conduction`` is not read: the JAX package's hierarchy has no
    conduction term (its level update is its own, not
    ``stepper._partial_update``), and this one gives the same state with
    the flag on or off, as that one does (a reference behaviour, ROADMAP
    C3)."""

    def __init__(self, cfg0: SimConfig, n_levels: Optional[int] = None,
                 states: Optional[List] = None, physics=None, device=None,
                 mesh=None):
        if n_levels is None:
            n_levels = cfg0.nlevels
        self.mesh = mesh
        self.device = (mesh.home if mesh is not None
                       else resolve_device(device))
        self.n_levels = n_levels
        self.cfg0 = cfg0
        self.centre = snap_ng_centre(cfg0)
        self.cfgs = [make_level_cfg(cfg0, l, self.centre)
                     for l in range(n_levels)]
        self.geoms = [make_geometry(c) for c in self.cfgs]

        # per-level child window in PARENT cell indices: level l>=1 covers
        # parent cells [offs[l][ax], offs[l][ax] + n//2) on each axis
        self.offs: List[Optional[Tuple[int, ...]]] = [None]
        # fine-level faces that coincide with the ROOT domain boundary get
        # the domain BC; all others get C2F prolongation ghosts
        self.dom_sides: List[List[Tuple[int, int]]] = [[]]
        for l in range(1, n_levels):
            cfg_c, cfg_f = self.cfgs[l - 1], self.cfgs[l]
            offs = []
            sides = []
            for ax in range(cfg0.ndim):
                n = cfg0.shape[ax]
                off_f = (cfg_f.xmin[ax] - cfg_c.xmin[ax]) / cfg_c.dx
                off = int(round(off_f))
                if abs(off_f - off) >= 1e-6:
                    raise ValueError(
                        f"level {l} axis {ax}: refinement window not cell-"
                        f"aligned (offset {off_f} parent cells; NG_centre must "
                        f"sit at i/4 of the domain and N must divide by 8 for "
                        f"odd i — reference setup_NG_grid.cpp:93-112)")
                if not (0 <= off and off + n // 2 <= n and n % 2 == 0):
                    raise ValueError(
                        f"level {l} axis {ax}: window [{off}, {off + n // 2}) "
                        f"does not fit {n} parent cells")
                offs.append(off)
                if np.isclose(cfg_f.xmin[ax], cfg0.xmin[ax]):
                    sides.append((ax, 0))
                if np.isclose(cfg_f.xmax[ax], cfg0.xmax[ax]):
                    sides.append((ax, 1))
            self.offs.append(tuple(offs))
            self.dom_sides.append(sides)

        self.physics = physics
        if physics is not None:
            # one Physics clone per level: same chemistry/sources, per-level
            # tracer geometry + wind masks (reference: sim_control_NG.cpp:138
            # setup_raytracing per level; RT_all_sources_levels :945-1011)
            self.phys = [physics.for_level(self.cfgs[l], self.geoms[l])
                         for l in range(n_levels)]
            for p in (physics.sources or []):
                if not p.at_infinity:
                    fine = self.cfgs[-1]
                    inside = all(fine.xmin[a] <= p.position[a] <= fine.xmax[a]
                                 for a in range(fine.ndim))
                    if not inside:
                        raise ValueError(
                            "point radiation sources must lie inside the "
                            "finest level (reference production configs do; "
                            "off-grid point-source tracing is "
                            "do_offgrid_raytracing, disabled upstream too: "
                            "sim_control_NG.cpp:959-969)")
        else:
            self.phys = [None] * n_levels
        self.t = 0.0
        self.step_count = 0
        self.last_dt = 0.0
        # small constant tensors (offset vectors, weights), made once
        self._consts: Dict = {}
        if states is not None:
            self.set_states(states)
        else:
            self.P = [None] * n_levels
            self.bdata = None
        # output policy (mirrors Simulation; reference: sim_init.cpp:671-760)
        self.outfile: Optional[str] = None
        self.opfreq = 0
        self.opfreq_time = 0.0
        self.checkpoint_freq = 0
        self.log_freq = 0
        self.params: Optional[dict] = None
        self._ckpt_flip = 0
        self._writer = None
        self._next_optime = None
        # CUDA graphs of chunks, by K, the layout of the sources' inputs and
        # the tracing mode (graphs.key)
        self._graphs: Dict = {}

    def set_states(self, states):
        """Each level's state: tensors or arrays, or level states sharded
        over one mesh (:class:`.parallel.mesh.Sharded`).  Plain states are
        split over the hierarchy's mesh, or over one made of the visible
        devices when ``cfg0.mesh`` asks for it (``mesh_requested``; a
        hierarchy does not read ``halo``, as the JAX package's does not)."""
        from .parallel.mesh import make_mesh, mesh_requested, shard_state

        if len(states) != self.n_levels:
            raise ValueError(f"{len(states)} states for {self.n_levels} "
                             f"levels")
        sharded = [isinstance(s, Sharded) for s in states]
        if any(sharded):
            meshes = {id(s.mesh) for s in states if isinstance(s, Sharded)}
            if not all(sharded) or len(meshes) > 1:
                raise ValueError(
                    "levels " + ", ".join(
                        str(l) for l, s in enumerate(states)
                        if not isinstance(s, Sharded)
                        or s.mesh is not states[0].mesh)
                    + " are not sharded over level 0's mesh: every level "
                    "of a hierarchy uses one mesh")
            self.mesh = states[0].mesh
        elif (self.mesh is None and mesh_requested(self.cfg0)
              and self.cfg0.halo != "explicit"):
            self.mesh = make_mesh(self.cfg0)
        if self.mesh is not None:
            self.device = self.mesh.home
        dtype = self.cfg0.torch_dtype
        # the strips of the frozen faces are taken from the states as given,
        # on the host, before they are cast
        host = [gather(s).detach().cpu().numpy()
                if isinstance(s, (torch.Tensor, Sharded))
                else np.asarray(s) for s in states]
        expect = (self.cfg0.nvar,) + self.cfg0.shape
        for l, s in enumerate(host):
            if s.shape != expect:
                raise ValueError(f"level {l} state shape {s.shape} != "
                                 f"{expect}")
        whole = [torch.as_tensor(s).to(dtype=dtype, device=self.device)
                 .contiguous() for s in host]
        self.bdata = make_fixed_strips(
            host[0].astype(self.cfg0.np_dtype), self.cfgs[0])
        # frozen INFLOW/FIXED ghost strips for fine-level domain faces
        # (full padded transverse shape, captured from the initial state by
        # edge replication — reference: BC_assign_INFLOW uses IC edge data)
        self.level_strips: List[Dict[Tuple[int, int], torch.Tensor]] = [{}]
        for l in range(1, self.n_levels):
            cfg = self.cfgs[l]
            strips = {}
            need = [(ax, sd) for (ax, sd) in self.dom_sides[l]
                    if cfg.bcs[ax][sd] in (BC.INFLOW, BC.FIXED)]
            if need:
                pad = apply_bcs_outflow_only(whole[l], cfg)
                ng = cfg.ng
                for ax, sd in need:
                    a = 1 + ax
                    strips[(ax, sd)] = (
                        pad.narrow(a, 0, ng) if sd == 0
                        else pad.narrow(a, pad.shape[a] - ng, ng)).clone()
            self.level_strips.append(strips)
        self.shards = None
        if self.mesh is None:
            self.P = whole
        else:
            # one shard side a level: its blocks' config, geometry, faces
            # and physics (level 0's faces from the whole grid's strips)
            self.shards = [_Shards(self.cfgs[l], self.mesh,
                                   self.bdata if l == 0 else None,
                                   self.phys[l])
                           for l in range(self.n_levels)]
            self.P = [shard_state(w, self.mesh) for w in whole]
        for l in range(self.n_levels):
            if self.phys[l] is None or not self.phys[l].winds:
                continue
            P = self.P[l]
            if self.shards is None:
                self.P[l] = self.phys[l].apply_internal_bcs(P, self.t)
            else:
                self.P[l] = Sharded(
                    [None if b is None else ph.apply_internal_bcs(b, self.t)
                     for ph, b in zip(self.shards[l].phys, P.blocks)],
                    P.mesh, P.shape)

    # -- small constants, kept ---------------------------------------------
    def _const(self, key, make, device=None):
        """A small constant tensor on ``device`` (the run's by default) in
        the run's dtype, made once from the numpy array ``make()`` gives."""
        device = self.device if device is None else device
        key = key + (str(device),)
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(np.asarray(make())).to(
                dtype=self.cfg0.torch_dtype, device=device)
        return self._consts[key]

    def _offvec(self, count: int, device=None):
        """Offsets of ``count`` fine cells from their parent's centre, in
        units of the parent's dx, for a window that starts on an even fine
        index: -1/4, +1/4, -1/4, ..."""
        return self._const(
            ("offvec", count),
            lambda: np.where(np.arange(count) % 2 == 0, -0.25, +0.25), device)

    # -- C2F prolongation --------------------------------------------------
    def _prolong_padded(self, Pc, level: int):
        """Fill the fine level's padded tensor from the parent: each fine
        cell (incl. ghosts) takes parent value + limited slope * offset
        (reference: NG_coarse_to_fine_boundaries.cpp:406-578
        interpolate_coarse2fine with AvgFalle slopes)."""
        cfg_f = self.cfgs[level]
        nd = cfg_f.ndim
        ng = cfg_f.ng
        if ng != 2:
            raise ValueError("the stride-2 upsample pattern assumes ghost "
                             "depth 2")
        off = self.offs[level]
        # parent index of each fine padded cell per axis: fine cell i_f
        # (counted from the child's xmin) sits in parent off + i_f//2 —
        # a regular pattern: parent window [off-1, off+n/2] edge-clamped,
        # each cell used twice (see _upsample2_clamped)
        starts = [off[ax] - 1 for ax in range(nd)]
        counts = [cfg_f.shape[ax] // 2 + ng for ax in range(nd)]

        def upsample_all(A):
            for ax in range(nd):
                A = _upsample2_clamped(A, 1 + ax, starts[ax], counts[ax])
            return A

        total = upsample_all(Pc)
        for ax in range(nd):
            a = 1 + ax
            n_c = Pc.shape[a]
            ppad = torch.cat([Pc.narrow(a, 0, 1), Pc,
                              Pc.narrow(a, n_c - 1, 1)], dim=a)
            d = torch.diff(ppad, dim=a)
            sl = van_albada(d.narrow(a, 0, d.shape[a] - 1),
                            d.narrow(a, 1, d.shape[a] - 1))
            sl = upsample_all(sl)
            shape = [1] * (nd + 1)
            shape[a] = 2 * counts[ax]
            total = total + sl * self._offvec(2 * counts[ax]).reshape(shape)
        return total

    def _prolong_window(self, Pc, level: int, franges, base=None):
        """Prolongated fine-padded values for the box given by per-axis
        fine ranges ``(fstart, fcount)`` in fine-padded coordinates
        i_f in [-ng, n+ng) (both even).  Identical values to the
        corresponding window of :meth:`_prolong_padded`, at window cost —
        the full-cube prolongation computes fine interior values that are
        immediately overwritten by the level's own state; the ghost shells
        are ~1/20 of the volume.  ``base``: the parent cell of ``Pc``'s
        first one along every axis, when ``Pc`` is a box of the parent
        (:meth:`_ghost_slabs`), not the whole of it."""
        cfg_f = self.cfgs[level]
        nd = cfg_f.ndim
        off = self.offs[level]
        base = (0,) * nd if base is None else base
        ps, pc = [], []
        for ax, (fs, fcnt) in enumerate(franges):
            if fs % 2 or fcnt % 2:
                raise ValueError(f"window ({fs}, {fcnt}) on axis {ax} is "
                                 f"not aligned with the parent's cells")
            ps.append(off[ax] + fs // 2 - base[ax])
            pc.append(fcnt // 2)

        # every axis is cut to the window first (views, but for clamped
        # edges) and only then is each cell repeated twice: nothing the size
        # of the level is copied for a window that is thin along one axis
        total = Pc
        for ax in range(nd):
            total = _clamped_slice(total, 1 + ax, ps[ax], pc[ax])
        for ax in range(nd):
            total = total.repeat_interleave(2, dim=1 + ax)
        for ax in range(nd):
            a = 1 + ax
            # limited slope at the parent rows of this window (one-row
            # margins, edge-clamped like the full-parent version)
            marg = _clamped_slice(Pc, a, ps[ax] - 1, pc[ax] + 2)
            for bx in range(nd):
                if bx != ax:
                    marg = _clamped_slice(marg, 1 + bx, ps[bx], pc[bx])
            d = torch.diff(marg, dim=a)
            sl = van_albada(d.narrow(a, 0, d.shape[a] - 1),
                            d.narrow(a, 1, d.shape[a] - 1))
            sl = sl.repeat_interleave(2, dim=a)
            for bx in range(nd):
                if bx != ax:
                    sl = sl.repeat_interleave(2, dim=1 + bx)
            shape = [1] * (nd + 1)
            shape[a] = 2 * pc[ax]
            total = total + sl * self._offvec(2 * pc[ax],
                                              Pc.device).reshape(shape)
        return total

    def _ghost_slabs(self, parent: Sharded, level: int):
        """The prolonged ghost shell of a sharded fine level, as
        :meth:`_pad_level` makes it on one device: the parent's window
        (with the slopes' margin, edge cells repeated past the grid)
        assembled once from the blocks that hold it
        (:func:`.parallel.mesh.region`), then a pair of slabs an axis, the
        slabs of axis a padded along the axes before it
        (``slabs[a][side]``).  The prolongation is the same function of the
        cell whatever window holds it, so a block's part of a slab is the
        one-device level's ghosts there.  On a mesh of several processes
        the window is assembled on every rank that owns a block on the
        level's outer boundary (None elsewhere)."""
        cfg = self.cfgs[level]
        ng, n, off = cfg.ng, cfg.shape, self.offs[level]
        box = [(o - ng, o + m // 2 + ng) for o, m in zip(off, n)]
        mesh = parent.mesh
        outer = [mesh.owner(b) for b, c in enumerate(mesh.coords)
                 if any(i in (0, f - 1) for i, f in zip(c, mesh.factors))]
        win = region(parent, box, self.device, dst=outer)
        if win is None:
            return None
        base = [lo for lo, _ in box]
        slabs = []
        for a in range(cfg.ndim):
            fr = [(-ng, m + 2 * ng) if bx < a else (0, m)
                  for bx, m in enumerate(n)]
            pair = []
            for face in ((-ng, ng), (n[a], ng)):
                fr[a] = face
                pair.append(self._prolong_window(win, level, fr, base))
            slabs.append(pair)
        return slabs

    def _pad_level(self, level: int, Ph, parent_state):
        """Padded state for level: domain BCs at level 0; C2F ghosts from
        the parent otherwise, except on faces coinciding with the root
        domain boundary, which apply the domain BC.  The result is a new
        contiguous tensor; on a mesh, one a block
        (:meth:`_pad_blocks`)."""
        if isinstance(Ph, Sharded):
            return self._pad_blocks(level, Ph, parent_state)
        cfg = self.cfgs[level]
        if level == 0:
            with tracing.span("fill"):
                return apply_bcs(Ph, cfg, self.bdata)
        padded = self._prolong_ghosts(level, Ph, parent_state)
        with tracing.span("fill"):
            for ax, sd in self.dom_sides[level]:
                padded = fill_ghost_side(
                    padded, cfg, ax, sd,
                    strip=self.level_strips[level].get((ax, sd)))
        return padded

    @tracing.spanned("glue.prolong")
    def _prolong_ghosts(self, level: int, Ph, parent_state):
        """``Ph`` of a fine level with its ghost shell prolonged from the
        parent (:meth:`_prolong_window`), every face."""
        cfg = self.cfgs[level]
        ng = cfg.ng
        nd = cfg.ndim
        n = cfg.shape
        # ghost slabs only (nested concat; corners come from the first
        # axis's full-transverse slabs, identical to the full prolongation)
        padded = Ph
        for ax in range(nd - 1, -1, -1):
            franges = []
            for bx in range(nd):
                if bx < ax:
                    franges.append((0, n[bx]))
                elif bx == ax:
                    franges.append(None)  # placeholder
                else:
                    franges.append((-ng, n[bx] + 2 * ng))
            fr_lo = list(franges)
            fr_lo[ax] = (-ng, ng)
            fr_hi = list(franges)
            fr_hi[ax] = (n[ax], ng)
            lo = self._prolong_window(parent_state, level, fr_lo)
            hi = self._prolong_window(parent_state, level, fr_hi)
            padded = torch.cat([lo, padded, hi], dim=1 + ax)
        return padded

    def _pad_blocks(self, level: int, Ph: Sharded, parent: Sharded):
        """Every block of a sharded level padded as :meth:`_pad_level` pads
        the whole level, sliced.  Level 0 takes the exchange and its faces
        (``halo.apply_bcs_sharded``).  A fine level's axes are padded in
        order, each from the blocks padded along the axes before it (so
        edges and corners arrive): a face between blocks takes the
        neighbour's strip; a face on the level's outer boundary its part of
        the level's prolonged ghost shell (:meth:`_ghost_slabs`), then a
        face on the root domain its BC, in the one-device
        order, from the block's own padded data and its slice of the frozen
        strip."""
        sh = self.shards[level]
        if level == 0:
            return sh.pads(Ph)
        cfg = self.cfgs[level]
        ng, mesh = cfg.ng, self.mesh
        slabs = self._ghost_slabs(parent, level)
        out = list(Ph.blocks)
        for axis in range(cfg.ndim):
            a = 1 + axis
            last = mesh.factors[axis] - 1

            def outer(b, side, axis=axis, last=last):
                return mesh.coords[b][axis] == (0, last)[side]

            strips = neighbour_strips(out, mesh, axis, ng,
                                      lambda b, side: not outer(b, side))
            padded = [None] * mesh.size
            for b in mesh.local:
                rng = sh.ranges[b]
                sides = []
                for side in (0, 1):
                    if not outer(b, side):
                        sides.append(strips[(b, side)])
                        continue
                    sides.append(slabs[axis][side][(slice(None),) + tuple(
                        slice(None) if bx == axis
                        else slice(lo, hi + 2 * ng) if bx < axis
                        else slice(lo, hi)
                        for bx, (lo, hi) in enumerate(rng))]
                        .to(out[b].device, non_blocking=True))
                padded[b] = torch.cat([sides[0], out[b], sides[1]], dim=a)
            out = padded
        for ax, sd in self.dom_sides[level]:
            strip = self.level_strips[level].get((ax, sd))
            for b in mesh.local:
                rng = sh.ranges[b]
                if mesh.coords[b][ax] != (0, mesh.factors[ax] - 1)[sd]:
                    continue
                part = None if strip is None else strip[(slice(None),) + tuple(
                    slice(None) if bx == ax else slice(lo, hi + 2 * ng)
                    for bx, (lo, hi) in enumerate(rng))]
                out[b] = fill_ghost_side(out[b], sh.cfg, ax, sd, strip=part)
        return out

    # -- F2C restriction ---------------------------------------------------
    @tracing.spanned("glue.restrict")
    def _restrict(self, Pc, Pf, level_f: int):
        """Replace covered coarse cells with the VOLUME-WEIGHTED
        conserved-variable average of their 2^ndim children (reference:
        NG_fine_to_coarse_boundaries.cpp:255-320 average_cells —
        sum(U*vol)/sum(vol); exact for cylindrical/spherical metrics).
        Returns a new tensor; neither ``Pc`` nor ``Pf`` is written."""
        cfg_c = self.cfgs[level_f - 1]
        nd = cfg_c.ndim
        off = self.offs[level_f]
        if isinstance(Pf, Sharded):
            # each child block's average (made by its owner), written into
            # whichever parent blocks hold its window
            return write_regions(Pc, [
                (tuple((off[a] + lo // 2, off[a] + hi // 2)
                       for a, (lo, hi) in enumerate(rng)),
                 None if blk is None
                 else self._restrict_window(blk, level_f, rng),
                 Pf.mesh.owner(b))
                for b, (blk, rng) in enumerate(zip(Pf.blocks, Pf.ranges()))])
        # window-only conversion: uncovered coarse cells stay bitwise
        # untouched
        P_win = self._restrict_window(Pf, level_f)
        sl = (slice(None),) + tuple(
            slice(off[ax], off[ax] + cfg_c.shape[ax] // 2)
            for ax in range(nd))
        out = Pc.clone()
        out[sl] = P_win
        return out

    def _restrict_window(self, Pf, level_f: int, rng=None):
        """The primitive volume-weighted average of every 2^ndim children of
        ``Pf``: the child level, or its block of global range ``rng``."""
        cfg_f = self.cfgs[level_f]
        nd = cfg_f.ndim
        dev = Pf.device

        # relative volume weights: absolute cgs volumes overflow float32
        def rel_volume():
            v64 = np.asarray(self.geoms[level_f].cell_volume,
                             dtype=np.float64)
            return v64 / v64.max()

        Vf = self._const(("relvol", level_f), rel_volume, dev)
        key = ("relvol_sum", level_f, str(dev))
        if key not in self._consts:
            V = Vf.expand(cfg_f.shape)
            for ax in range(nd):
                V = _pairsum(V, ax)
            self._consts[key] = V
        Vs = self._consts[key]
        if rng is not None:
            Vf = Vf[tuple(slice(lo, hi) if n > 1 else slice(None)
                          for (lo, hi), n in zip(rng, Vf.shape))]
            Vs = Vs[tuple(slice(lo // 2, hi // 2) for lo, hi in rng)]
        W = prim_to_cons(Pf, cfg_f) * Vf
        for ax in range(nd):
            W = _pairsum(W, 1 + ax)
        return cons_to_prim(W / Vs, self.cfgs[level_f - 1])

    # -- BC89 flux correction ----------------------------------------------
    def _face_weights(self, level: int, ax: int) -> Dict[int, np.ndarray]:
        """Per-transverse-axis area weight vectors for faces normal to
        ``ax`` (reference: face areas VectorOps.cpp:688-697).  Cartesian:
        uniform.  Cylindrical z-faces: area per R-row proportional to
        R_centre (pi*((R+)^2-(R-)^2) = 2 pi R dR)."""
        cfg = self.cfgs[level]
        out = {}
        for bx in range(cfg.ndim):
            if bx == ax:
                continue
            g = self.geoms[level].axes[bx]
            if g.is_radial and cfg.coords is Coord.CYLINDRICAL:
                ng = cfg.ng
                out[bx] = np.asarray(
                    g.pos[ng: ng + cfg.shape[bx]], dtype=cfg.np_dtype)
            else:
                out[bx] = np.ones(cfg.shape[bx], dtype=cfg.np_dtype)
        return out

    @tracing.spanned("glue.restrict")
    def _restrict_face_flux(self, Ff, ax, level_f: int, rng=None):
        """Area-weighted average of the fine boundary-plane flux onto
        coarse faces: 2^(nd-1) fine faces per coarse face (reference:
        NG_BC89flux.cpp recv_BC89_fluxes_F2C sums F*dA / sum dA).  ``rng``:
        the global range of the block whose plane ``Ff`` is, when it is
        one block's."""
        cfg_f = self.cfgs[level_f]
        nd = cfg_f.ndim
        out = Ff
        # Ff: (nvar, ...transverse...) with the sweep axis removed
        k = 0
        for bx in range(nd):
            if bx == ax:
                continue
            a = 1 + k
            shape = (1,) * a + (-1,) + (1,) * (out.ndim - a - 1)
            w = self._const(
                ("facew", level_f, ax, bx),
                lambda: self._face_weights(level_f, ax)[bx], Ff.device)
            den = self._const(
                ("facew_sum", level_f, ax, bx),
                lambda: self._face_weights(level_f, ax)[bx].reshape(
                    -1, 2).sum(axis=1), Ff.device)
            if rng is not None:
                lo, hi = rng[bx]
                w, den = w[lo:hi], den[lo // 2:hi // 2]
            out = _pairsum(out * w.reshape(shape), a) / den.reshape(shape)
            k += 1
        return out

    def _bc89_correct(self, dU, get_face, fine_face_sums, level: int, dt):
        """Adjust the dU of coarse cells just outside the fine grid so the
        interface flux equals the time-averaged fine flux (Berger & Colella
        1989; reference: NG_BC89flux.cpp recv_BC89_fluxes_F2C).  Skipped on
        faces where the child touches the domain boundary (no outside
        cell).  ``get_face(ax, i)`` returns the full transverse interface
        plane at index i of axis ax.  ``dU`` is written in place and
        returned: the caller hands in its own fresh tensor."""
        cfg = self.cfgs[level]
        nd = cfg.ndim
        off_c = self.offs[level + 1]
        for ax in range(nd):
            n = cfg.shape[ax]
            lo_i = off_c[ax]               # coarse interface index, low side
            hi_i = off_c[ax] + n // 2      # high side
            Ff_lo, Ff_hi = fine_face_sums[ax]   # restricted fine fluxes
            g = self.geoms[level].axes[ax]

            # full-rank index helper: transverse window covered by the fine
            # grid, position i on the sweep axis
            def widx(i):
                sl = [slice(None)]
                for bx in range(nd):
                    if bx == ax:
                        sl.append(i)
                    else:
                        sl.append(slice(off_c[bx],
                                        off_c[bx] + cfg.shape[bx] // 2))
                return tuple(sl)

            def wplane(plane):
                # window a full transverse interface plane to the child
                sl = [slice(None)]
                for bx in range(nd):
                    if bx == ax:
                        continue
                    sl.append(slice(off_c[bx],
                                    off_c[bx] + cfg.shape[bx] // 2))
                return plane[tuple(sl)]

            # the coarse cell OUTSIDE the low interface is lo_i-1 (its HIGH
            # face, coefficient cp): dudt = cn*f_lo - cp*f_hi, so swapping
            # the coarse flux for the fine one adds cp*(F_coarse - F_fine).
            # At the high interface the outside cell is hi_i and its LOW
            # face gets the opposite sign.
            if lo_i > 0:
                corr_lo = wplane(get_face(ax, lo_i)) - Ff_lo
                dU[widx(lo_i - 1)] += dt * float(g.div_cp[lo_i - 1]) * corr_lo
            if hi_i < n:
                corr_hi = wplane(get_face(ax, hi_i)) - Ff_hi
                dU[widx(hi_i)] += -dt * float(g.div_cn[hi_i]) * corr_hi
        return dU

    # -- per-level radiation columns ----------------------------------------
    def _child_tau_offsets(self, level: int, Ph, tau_in):
        """Entry-column offsets for level+1's sources-at-infinity: this
        level's tau field sliced at the child's upstream boundary plane,
        windowed to the child's transverse footprint and prolonged 2x
        (the equivalent of the reference's C2F boundary Tau data,
        NG_coarse_to_fine_boundaries.cpp + cell extra_data columns).
        Point sources need no offset: production configs keep them inside
        every level."""
        phys = self.phys[level]
        if phys is None or not phys.sources:
            return None
        inf_idx = [i for i, s in enumerate(phys.sources) if s.at_infinity]
        if not inf_idx:
            return None
        cfg = self.cfgs[level]
        nd = cfg.ndim
        off_c = self.offs[level + 1]
        if isinstance(Ph, Sharded):
            taus = phys.trace_taus_sharded(Ph, self.shards[level].phys,
                                           tau_in)
        else:
            taus = phys.trace_taus(Ph, tau_in)
        out = {}
        for i in inf_idx:
            s = phys.sources[i]
            ax = s.axis
            idx = (off_c[ax] if s.sign > 0
                   else off_c[ax] + cfg.shape[ax] // 2 - 1)
            if isinstance(Ph, Sharded):
                # the plane from the blocks that hold it
                plane = region(taus[i], [
                    (idx, idx + 1) if bx == ax else (0, cfg.shape[bx])
                    for bx in range(nd)]).select(ax, 0)
            else:
                plane = taus[i].select(ax, idx)  # (transverse parent)
            # window to the child's footprint then prolong 2x per axis
            k = 0
            for bx in range(nd):
                if bx == ax:
                    continue
                plane = plane.narrow(k, off_c[bx], cfg.shape[bx] // 2)
                plane = plane.repeat_interleave(2, dim=k)
                k += 1
            out[i] = plane.unsqueeze(ax)  # broadcasts along the ray
        return out

    # -- time stepping -----------------------------------------------------
    def _level_dt(self, states, sp=None, rt0_map=None):
        """The hierarchy's dt before the growth limit and the caps, a 0-d
        tensor: each level's CFL dt, and chemistry limit where there is one,
        times 2^level, then the least of them (reference policy:
        sim_control_NG.cpp:288-341 coarse dt = 2^l * finest-limited dt;
        chemistry limit per calc_timestep.cpp:342).

        With ``rt0_map`` (a dict to fill) the radiation columns of point
        sources are traced once through each level's state and kept there
        with the limit's ydot under ``"f0"``, for that level's first
        predictor."""
        vals = []
        for l in range(self.n_levels):
            phys = self.phys[l]
            if isinstance(states[l], Sharded):
                vals.append(self._block_limits(l, states[l], sp, rt0_map)
                            * (2 ** l))
                continue
            excl = (phys.wind_exclude_mask(states[l])
                    if phys is not None and phys.winds else None)
            d = dynamics_dt(states[l], self.cfgs[l], self.geoms[l],
                            exclude=excl)
            if (phys is not None and phys.dt_limit
                    and phys.mp is not None):
                r = None
                if (rt0_map is not None and phys.sources and not any(
                        s.at_infinity for s in phys.sources)):
                    # point-source columns need no parent tau offsets:
                    # trace once, reuse in the predictor
                    r = phys.raytrace(states[l], sp=sp)
                if r is not None:
                    # the dt-limit ydot doubles as the predictor update's
                    # first evaluation (same state, same columns) — carried
                    # through rt0_map[l]["f0"]
                    ts, f0 = phys.timescale(states[l], self.cfgs[l], rt=r,
                                            sp=sp, with_ydot=True)
                    r = dict(r)
                    if f0 is not None:
                        r["f0"] = f0
                    rt0_map[l] = r
                    d = torch.minimum(d, ts)
                else:
                    d = torch.minimum(
                        d, phys.timescale(states[l], self.cfgs[l], sp=sp))
            vals.append(d * (2 ** l))
        return torch.min(torch.stack(vals))

    def _block_limits(self, level: int, S: Sharded, sp=None, rt0_map=None):
        """:meth:`_level_dt`'s limit of one sharded level, before the
        2^level: the min over its blocks of each block's CFL dt and
        chemistry limit, the columns traced across the shards (and kept
        in ``rt0_map``, a dict a block, where the one-device path keeps
        them)."""
        phys, sh = self.phys[level], self.shards[level]
        limit = (phys is not None and phys.dt_limit
                 and phys.mp is not None)
        rts = sh.raytrace(S, sp) if limit and phys.sources else None
        keep = (limit and rt0_map is not None and phys.sources
                and not any(s.at_infinity for s in phys.sources))
        vals, kept = [], [None] * S.mesh.size
        for b, blk in S.local():
            pb = sh.phys[b]
            excl = pb.wind_exclude_mask(blk) if pb is not None and pb.winds \
                else None
            d = dynamics_dt(blk, sh.cfg, sh.geoms[b], exclude=excl)
            if limit:
                r = None if rts is None else rts[b]
                if keep:
                    ts, f0 = pb.timescale(blk, sh.cfg, rt=r, sp=sp,
                                          with_ydot=True)
                    r = dict(r)
                    if f0 is not None:
                        r["f0"] = f0
                    kept[b] = r
                else:
                    ts = pb.timescale(blk, sh.cfg, rt=r, sp=sp)
                d = torch.minimum(d, ts)
            vals.append(d)
        if keep:
            rt0_map[level] = kept
        return sh.reduce(vals, torch.min)

    def compute_dt(self, sp=None) -> float:
        dt0 = float(self._level_dt(self.P, sp))
        if self.last_dt > 0.0:
            dt0 = min(dt0, self.cfgs[0].max_dt_growth * self.last_dt)
        return dt0

    def _advance_level(self, level: int, dt, parent_state=None,
                       tau_in=None, t0=None, states=None, sp=None,
                       rt0_map=None):
        """One OA2 step of `level` with two recursive substeps of level+1.
        Returns the time-summed restricted boundary-plane fluxes for the
        parent's BC89 correction (reference: sim_control_NG.cpp:679-810).
        ``tau_in``: per-source upstream column offsets handed down by the
        parent (sources at infinity only).  ``states``: the list the
        recursion reads and rebinds entries of (never the tensors in it);
        defaults to ``self.P``.  ``dt`` is a number or a 0-d tensor.  A
        sharded level steps block by block (:meth:`_advance_blocks`)."""
        if states is None:
            states = self.P
        if isinstance(states[level], Sharded):
            return self._advance_blocks(level, dt, parent_state, tau_in, t0,
                                        states, sp, rt0_map)
        cfg = self.cfgs[level]
        geom = self.geoms[level]
        phys = self.phys[level]
        P = states[level]
        scma = _scma_flag(phys)
        glm = cfg.eqn is Eqn.GLM
        ch = cfg.cfl * geom.dx / dt if glm else None
        if t0 is None:
            t0 = self.t
        # the wrappers launch the CUDA kernels for a CUDA tensor and take
        # their plain versions for a CPU tensor
        fused = cfg.kernels != "off" and fused_sweep.supports(cfg)

        # predictor half-step (1st-order space); the predictor needs no
        # face fluxes, so the fused kernels apply directly
        Ppad = self._pad_level(level, P, parent_state)
        with tracing.span("sweep"):
            if fused:
                dU_h = fused_sweep.dynamics_dU_fused(
                    Ppad, cfg, geom, 0.5 * dt, 1, ch=ch, scma=scma)
            else:
                dU_h, _ = dynamics_dU(Ppad, cfg, geom, 0.5 * dt, 1,
                                      ch=ch, scma=scma)
        if phys is not None and phys.mp is not None:
            # reuse the columns traced through this pre-step state by the
            # fused dt computation, when available (first touch per level)
            rt_pre = (rt0_map or {}).get(level)
            with tracing.span("chem"):
                dU_h = dU_h + phys.mp_delta_U(P, P, 0.5 * dt, cfg, tau_in,
                                              sp=sp, rt=rt_pre)
        with tracing.span("update"):
            Ph = cell_advance(P, dU_h, cfg)
            if glm:
                Ph = glm_psi_damp(Ph, 0.5 * dt, ch, cfg, geom)
        if phys is not None and phys.winds:
            Ph = phys.apply_internal_bcs(Ph, later(t0, 0.5 * dt))

        # columns handed to the child (lagged by a half step, like the
        # reference's boundary-data Tau: RT runs before the C2F send,
        # sim_control_NG.cpp:653-656)
        tau_child = (self._child_tau_offsets(level, Ph, tau_in)
                     if level + 1 < self.n_levels else None)

        # first fine substep (C2F ghosts frozen at this level's Ph)
        fine_sums_1 = None
        if level + 1 < self.n_levels:
            fine_sums_1 = self._advance_level(level + 1, 0.5 * dt, Ph,
                                              tau_child, t0, states, sp,
                                              rt0_map)

        # second fine substep
        fine_sums_2 = None
        if level + 1 < self.n_levels:
            fine_sums_2 = self._advance_level(level + 1, 0.5 * dt, Ph,
                                              tau_child, later(t0, 0.5 * dt),
                                              states, sp)

        # corrector (2nd-order space), after the second fine substep, which
        # reads nothing of it (only Ph), so that its dU and interface planes
        # are not held through the finer levels' steps.  On the fast path
        # the fused kernels compute the dU and write the handful of
        # interface planes that BC89 / boundary restriction need as they
        # solve them (the plain sweep's face tensors at those indices);
        # otherwise the plain sweep keeps its faces.
        Ppad = self._pad_level(level, Ph, parent_state)
        use_fast = (fused and cfg.coords is Coord.CARTESIAN
                    and cfg.av is AV.FALLE)
        if use_fast:
            with tracing.span("sweep"):
                dU_f, planes = fused_sweep.dynamics_dU_fused(
                    Ppad, cfg, geom, dt, 2, ch=ch, scma=scma,
                    planes={ax: sorted(p) for ax, p
                            in enumerate(self._face_pairs(level))})

            def get_face(ax_, i_):
                return planes[(ax_, i_)]
        else:
            with tracing.span("sweep"):
                dU_f, faces = dynamics_dU(Ppad, cfg, geom, dt, 2, ch=ch,
                                          scma=scma)

            def get_face(ax_, i_):
                return faces[ax_].select(1 + ax_, i_)
        if phys is not None and phys.mp is not None:
            with tracing.span("chem"):
                dU_f = dU_f + phys.mp_delta_U(P, Ph, dt, cfg, tau_in,
                                              sp=sp)

        # BC89: correct this level's dU with the fine fluxes
        if level + 1 < self.n_levels:
            sums = []
            with tracing.span("glue.bc89"):
                for ax in range(cfg.ndim):
                    lo = 0.5 * (fine_sums_1[ax][0] + fine_sums_2[ax][0])
                    hi = 0.5 * (fine_sums_1[ax][1] + fine_sums_2[ax][1])
                    sums.append((lo, hi))
                dU_f = self._bc89_correct(dU_f, get_face, sums, level, dt)

        with tracing.span("update"):
            P_new = cell_advance(P, dU_f, cfg)
            if glm:
                P_new = glm_psi_damp(P_new, dt, ch, cfg, geom)
            if phys is not None and phys.mp is not None:
                # temperature ceiling (reference: grid_update_state_vector
                # clamps, time_integrator.cpp:881-940)
                T = phys.mp.temperature(P_new, cfg)
                P_new = torch.where(T > cfg.max_temperature,
                                    phys.mp.set_temp(P_new,
                                                     cfg.max_temperature,
                                                     cfg), P_new)
        if phys is not None and phys.winds:
            P_new = phys.apply_internal_bcs(P_new, later(t0, dt))

        # F2C restriction
        if level + 1 < self.n_levels:
            P_new = self._restrict(P_new, states[level + 1], level + 1)
        states[level] = P_new

        # boundary-plane fluxes of this level, restricted to parent faces
        if level == 0:
            return None
        out = []
        for ax in range(cfg.ndim):
            lo = self._restrict_face_flux(get_face(ax, 0), ax, level)
            hi = self._restrict_face_flux(get_face(ax, cfg.shape[ax]), ax,
                                          level)
            out.append((lo, hi))
        return out

    def _advance_blocks(self, level: int, dt, parent_state=None,
                        tau_in=None, t0=None, states=None, sp=None,
                        rt0_map=None):
        """:meth:`_advance_level` of a sharded level: the same steps block
        by block, each with its config, geometry and physics
        (``self.shards[level]``), its ghosts from :meth:`_pad_blocks`.
        The chemistry takes its columns traced across the shards and,
        plain, its ladder over every block (``stepper._Shards``); BC89
        corrects the parent cells beside the child in whichever blocks hold
        them; the face planes a parent or BC89 needs come from the blocks
        that hold the interface (with ``use_fast`` from 4-cell slabs of
        those blocks, two at a time where both lie in one), and the child's
        boundary planes are assembled over its blocks on the first
        shard's device.  On a mesh of several processes each process steps
        its own blocks (the lists hold None at the others')."""
        cfg, geom, phys = self.cfgs[level], self.geoms[level], self.phys[level]
        sh = self.shards[level]
        P = states[level]
        blocks = P.mesh.local
        nblk = P.mesh.size
        scma = _scma_flag(phys)
        glm = cfg.eqn is Eqn.GLM
        chem = phys is not None and phys.mp is not None
        ch = cfg.cfl * geom.dx / dt if glm else None
        if t0 is None:
            t0 = self.t
        fused = cfg.kernels != "off" and fused_sweep.supports(cfg)
        child = level + 1 < self.n_levels
        half = 0.5 * dt

        def on(x, b):
            return _on(x, P.blocks[b])

        def each(fn):
            """``fn(b)`` of this process's blocks, None at the others'."""
            out = [None] * nblk
            for b in blocks:
                out[b] = fn(b)
            return out

        def sweep(pads, dt_, order, fused=fused):
            if fused:
                return each(lambda b: fused_sweep.dynamics_dU_fused(
                    pads[b], sh.cfg, sh.geoms[b], on(dt_, b), order,
                    ch=on(ch, b), scma=scma)), None
            outs = each(lambda b: dynamics_dU(
                pads[b], sh.cfg, sh.geoms[b], on(dt_, b), order,
                ch=on(ch, b), scma=scma))
            return ([None if o is None else o[0] for o in outs],
                    [None if o is None else o[1] for o in outs])

        def chemistry(dU, state, dt_):
            rt = (rt0_map or {}).get(level) if state is P else None
            if rt is None and phys.sources:
                rt = sh.raytrace(state, sp, tau_in)
            new = sh.chemistry(P, dt_, rt)
            return each(lambda b: dU[b] + sh.phys[b].mp_delta_U(
                P.blocks[b], state.blocks[b], on(dt_, b), sh.cfg,
                rt=None if rt is None else rt[b], sp=sp,
                P_new=None if new is None else new[b]))

        def finish(dU, dt_, t_end, ceiling):
            out = [None] * nblk
            for b in blocks:
                Pn = cell_advance(P.blocks[b], dU[b], sh.cfg)
                if glm:
                    Pn = glm_psi_damp(Pn, on(dt_, b), on(ch, b), sh.cfg,
                                      sh.geoms[b])
                pb = sh.phys[b]
                if ceiling and chem:
                    T = pb.mp.temperature(Pn, sh.cfg)
                    Pn = torch.where(T > cfg.max_temperature,
                                     pb.mp.set_temp(Pn, cfg.max_temperature,
                                                    sh.cfg), Pn)
                if pb is not None and pb.winds:
                    Pn = pb.apply_internal_bcs(Pn, later(on(t0, b),
                                                         on(t_end, b)))
                out[b] = Pn
            return Sharded(out, P.mesh, P.shape)

        # predictor half-step (1st-order space)
        dU_h, _ = sweep(self._pad_blocks(level, P, parent_state), half, 1)
        if chem:
            dU_h = chemistry(dU_h, P, half)
        Ph = finish(dU_h, half, half, False)

        tau_child = (self._child_tau_offsets(level, Ph, tau_in)
                     if child else None)
        fine_sums_1 = (self._advance_level(level + 1, half, Ph, tau_child,
                                           t0, states, sp, rt0_map)
                       if child else None)

        # corrector (2nd-order space) and the face planes of its blocks:
        # on the fast path from slabs (faces None), else the plain sweep's
        pads = self._pad_blocks(level, Ph, parent_state)
        use_fast = (fused and cfg.coords is Coord.CARTESIAN
                    and cfg.av is AV.FALLE)
        dU_f, faces = sweep(pads, dt, 2, fused=use_fast)
        pair_of = self._face_pairs(level)
        _fcache: Dict = {}

        def get_face(b, ax_, i_):
            """Block ``b``'s face plane at global interface ``i_`` of
            ``ax_`` (one its range holds), over the block's span."""
            lo = sh.ranges[b][ax_][0]
            if faces is not None:
                return faces[b][ax_].select(1 + ax_, i_ - lo)
            if (b, ax_, i_) not in _fcache:
                j2 = pair_of[ax_].get(i_)
                args = (on(dt, b), 2)
                kw = dict(ch=on(ch, b), scma=scma)
                if (j2 is not None and j2 != i_
                        and lo <= j2 <= sh.ranges[b][ax_][1]
                        and (b, ax_, j2) not in _fcache):
                    j_lo, j_hi = sorted((i_, j2))
                    (_fcache[(b, ax_, j_lo)],
                     _fcache[(b, ax_, j_hi)]) = interface_flux_pair(
                        pads[b], sh.cfg, sh.geoms[b], ax_, j_lo - lo,
                        j_hi - lo, *args, **kw)
                else:
                    _fcache[(b, ax_, i_)] = interface_flux(
                        pads[b], sh.cfg, sh.geoms[b], ax_, i_ - lo, *args,
                        **kw)
            return _fcache[(b, ax_, i_)]

        if chem:
            dU_f = chemistry(dU_f, Ph, dt)
        fine_sums_2 = (self._advance_level(level + 1, half, Ph, tau_child,
                                           later(t0, half), states, sp)
                       if child else None)
        if child:
            # (None on a side whose fine sums this process does not need)
            sums = [tuple(None if a is None else 0.5 * (a + b)
                          for a, b in zip(f1, f2))
                    for f1, f2 in zip(fine_sums_1, fine_sums_2)]
            self._bc89_blocks(dU_f, get_face, sums, level, dt)
        P_new = finish(dU_f, dt, dt, True)
        if child:
            P_new = self._restrict(P_new, states[level + 1], level + 1)
        states[level] = P_new
        if level == 0:
            return None
        return [tuple(self._face_sums(get_face, ax, side, level)
                      for side in (0, 1)) for ax in range(cfg.ndim)]

    def _bc89_targets(self, level: int, ax: int, side: int):
        """The blocks of ``level`` (a parent) whose coarse cells just
        outside the child, on ``side`` of axis ``ax``, BC89 corrects (each
        with its part of the child's footprint and its cell), as
        :meth:`_bc89_blocks` walks them."""
        cfg, sh = self.cfgs[level], self.shards[level]
        off_c = self.offs[level + 1]
        n = cfg.shape[ax]
        cell = (off_c[ax] - 1, off_c[ax] + n // 2)[side]
        out = []
        if not 0 <= cell < n:
            return out
        for b, rng in enumerate(sh.ranges):
            # the block's part of the child's footprint across ax
            cut = [(max(lo, off_c[bx]),
                    min(hi, off_c[bx] + cfg.shape[bx] // 2))
                   for bx, (lo, hi) in enumerate(rng)]
            if any(c0 >= c1 for bx, (c0, c1) in enumerate(cut) if bx != ax):
                continue
            if rng[ax][0] <= cell < rng[ax][1]:
                out.append((b, cut, cell))
        return out

    def _face_sums(self, get_face, ax: int, side: int, level: int):
        """The restricted boundary-plane flux of one face of a sharded
        level (:meth:`_restrict_face_flux` of each block on that face),
        assembled over the blocks on the first shard's device.  On a mesh
        of several processes each block's part goes from its owner to each
        rank whose parent blocks BC89 corrects there
        (:meth:`_bc89_targets`), in one phase; elsewhere the result is
        None."""
        from .parallel.comm import Move

        cfg, sh, mesh = self.cfgs[level], self.shards[level], self.mesh
        i = (0, cfg.shape[ax])[side]
        face = [(b, rng) for b, rng in enumerate(sh.ranges)
                if mesh.coords[b][ax] == (0, mesh.factors[ax] - 1)[side]]
        to = (sorted({mesh.owner(b) for b, _, _
                      in self._bc89_targets(level - 1, ax, side)})
              if mesh.distributed else [mesh.rank])
        moves, where = [], []
        for b, rng in face:
            part = (self._restrict_face_flux(get_face(b, ax, i), ax, level,
                                             rng) if mesh.owns(b) else None)
            shape = (cfg.nvar,) + tuple((hi - lo) // 2 for bx, (lo, hi)
                                        in enumerate(rng) if bx != ax)
            for q in to:
                where.append(rng)
                moves.append(Move(mesh.owner(b), q, part, shape,
                                  self.cfg0.torch_dtype, self.device))
        got = mesh.transfer(moves)
        if mesh.rank not in to:
            return None
        out = None
        for rng, m, part in zip(where, moves, got):
            if m.dst != mesh.rank:
                continue
            if out is None:
                out = part.new_empty((part.shape[0],) + tuple(
                    n // 2 for bx, n in enumerate(cfg.shape) if bx != ax),
                    device=self.device)
            out[(slice(None),) + tuple(
                slice(lo // 2, hi // 2) for bx, (lo, hi) in enumerate(rng)
                if bx != ax)] = part
        return out

    def _bc89_blocks(self, dU, get_face, fine_face_sums, level: int, dt):
        """:meth:`_bc89_correct` of a sharded level: each block that holds
        coarse cells just outside the child corrects its own, from its own
        face plane and its part of the fine sums.  ``dU``: the blocks'
        fresh tensors, written in place."""
        cfg, sh, mesh = self.cfgs[level], self.shards[level], self.mesh
        off_c = self.offs[level + 1]
        for ax in range(cfg.ndim):
            g = self.geoms[level].axes[ax]
            for side in (0, 1):
                iface = off_c[ax] + (0, cfg.shape[ax] // 2)[side]
                for b, cut, cell in self._bc89_targets(level, ax, side):
                    if not mesh.owns(b):
                        continue
                    rng = sh.ranges[b]
                    blo = rng[ax][0]
                    plane = get_face(b, ax, iface)[(slice(None),) + tuple(
                        slice(c0 - lo, c1 - lo) for bx, ((c0, c1), (lo, _))
                        in enumerate(zip(cut, rng)) if bx != ax)]
                    fine = fine_face_sums[ax][side][(slice(None),) + tuple(
                        slice(c0 - off_c[bx], c1 - off_c[bx])
                        for bx, (c0, c1) in enumerate(cut) if bx != ax)]
                    corr = plane - fine.to(plane.device, non_blocking=True)
                    sl = (slice(None),) + tuple(
                        cell - blo if bx == ax else slice(c0 - lo, c1 - lo)
                        for bx, ((c0, c1), (lo, _))
                        in enumerate(zip(cut, rng)))
                    dtb = _on(dt, dU[b])
                    if side == 0:
                        dU[b][sl] += dtb * float(g.div_cp[cell]) * corr
                    else:
                        dU[b][sl] += -dtb * float(g.div_cn[cell]) * corr

    def _face_pairs(self, level: int):
        """The interface planes the corrector of ``level`` hands on (its
        boundary planes, the child's), a dict an axis from each to its
        partner.  The one-device corrector has B1 write these planes; a
        sharded level computes a known pair two at a time from one 8-cell
        slab."""
        cfg = self.cfgs[level]
        pair_of = [dict() for _ in range(cfg.ndim)]
        if level > 0:
            for ax in range(cfg.ndim):
                pair_of[ax][0] = cfg.shape[ax]
                pair_of[ax][cfg.shape[ax]] = 0
        if level + 1 < self.n_levels:
            for ax, o in enumerate(self.offs[level + 1]):
                pair_of[ax].setdefault(o, o + cfg.shape[ax] // 2)
                pair_of[ax].setdefault(o + cfg.shape[ax] // 2, o)
        return pair_of

    def _dt_cap(self) -> float:
        """End-time / next-timed-output ceiling (reference:
        timestep_checking_and_limiting, calc_timestep.cpp:243-252)."""
        tmax = getattr(self, "_tmax", None) or self.cfgs[0].tmax
        cap = tmax - self.t
        # first-step wind-speed ceiling, scaled from the finest level to
        # the root dt (reference: calc_dynamics_dt timestep-0 wind cap)
        if (self.step_count == 0 and self.physics is not None
                and self.physics.wind_sources):
            fine = self.n_levels - 1
            cap = min(cap, self.phys[fine].wind_dt_cap(self.cfgs[fine],
                                                       self.geoms[fine])
                      * 2 ** fine)
        if self.opfreq_time > 0.0 and self.outfile is not None:
            nxt = self._next_optime
            if nxt is None:
                nxt = self.t + self.opfreq_time
            to_next = nxt - self.t
            tol = 1.0e-12 * max(abs(nxt), self.opfreq_time)
            if to_next <= tol:
                to_next += self.opfreq_time
            cap = min(cap, to_next)
        return max(cap, 0.0)

    def step(self, dt: float = None) -> float:
        """One hierarchy step: level 0 once, level l 2^l times.

        Without ``dt`` the step computes it: the per-level limits, the
        growth clamp and the end/output-time cap, and the radiation columns
        traced for the chemistry dt limit are reused by each level's first
        predictor (the reference also raytraces once per partial update —
        time_integrator.cpp:206-243; dt policy per calc_timestep.cpp:219-260
        with the coarse dt slaved to the finest, sim_control_NG.cpp:288-341).
        That ``dt`` is the one value read back from the device."""
        sp = self._sources()
        states = list(self.P)
        if dt is None:
            states, dtv = self._dt_and_advance(states, self.t, self.last_dt,
                                               self._dt_cap(), sp)
            dt = float(dtv)
        else:
            self._advance_level(0, dt, t0=self.t, states=states, sp=sp)
        self.P = states
        self.t += dt
        self.last_dt = dt
        self.step_count += 1
        return dt

    def _sources(self):
        """The evolving sources' parameters at ``t`` on the run's device
        (``Physics.update_sources``, then ``device_sp``), or None."""
        if self.physics is None or not self.physics.sources:
            return None
        return self.physics.device_sp(self.physics.update_sources(self.t),
                                      self.P[0])

    def _dt_and_advance(self, states, t, last_dt, cap, sp):
        """The step without its host work: the levels' dt, the growth limit
        and the cap (``stepper.limit_dt``), and the recursion from level 0.
        ``t``, ``last_dt`` and ``cap`` are host numbers (``step``) or
        float64 0-d tensors (a chunk).  Returns the new states and the 0-d
        ``dt``, unread."""
        rt0_map: Dict = {}
        with tracing.span("step.dt"):
            dtv = self._level_dt(states, sp, rt0_map)
            dtv = limit_dt(dtv, last_dt, cap, self.cfgs[0].max_dt_growth)
        states = list(states)
        self._advance_level(0, dtv, t0=t, states=states, sp=sp,
                            rt0_map=rt0_map)
        return states, dtv

    def _chunk(self, states, t, last_dt, t_stop, t_target, sp, K: int):
        """K hierarchy steps on the device (the body of the JAX package's
        ``_multi_step_fn``, ng.py:854-866).  ``t``, ``last_dt``, ``t_stop``
        and ``t_target`` are float64 0-d tensors.  A step is live while
        ``t < t_stop`` (the run loop's test) and is capped at ``t_target -
        t``; a step that is not live is capped at 1 and dropped, so the
        states pass through.  Returns the states and ``(2, K)`` float64:
        dt (0 where not live) and live."""
        rows = []
        states = tuple(states)
        for _ in range(K):
            with tracing.span("step.select"):
                live = t < t_stop
                cap = torch.where(live, t_target - t, 1.0)
            st, dtv = self._dt_and_advance(states, t, last_dt, cap, sp)
            with tracing.span("step.select"):
                states = tuple(select(live, a, b)
                               for a, b in zip(st, states))
                dt64 = dtv.to(torch.float64)
                dt_eff = torch.where(live, dt64, 0.0)
                t = t + dt_eff
                last_dt = torch.where(live, dt64, last_dt)
                rows.append(torch.stack([dt_eff, live.to(torch.float64)]))
        return states, torch.stack(rows, dim=1)

    def _multi_step_fn(self, K: int):
        """K hierarchy steps in one dispatch (the JAX package's
        ``_multi_step_fn``, a ``lax.scan``): ``run_k(states, t, last_dt,
        t_target, sp=None) -> (states, info)`` with host numbers ``t``,
        ``last_dt`` and ``t_target``, ``sp`` from :meth:`_sources`, and
        ``info`` the ``(2, K)`` of :meth:`_chunk`.  On the card with the
        kernels on, one replay of a CUDA graph recorded at the first call
        for each K, ``sp`` layout and tracing mode (:func:`.graphs.key`;
        raising if the recording fails); with ``kernels="off"``, whose
        plain chemistry reads the host, on the CPU and with tracing in its
        "device" mode, eagerly, step after step.  On a mesh the same: one
        graph when every shard lies on one card, eagerly over several
        devices."""
        from . import graphs

        def run_k(states, t, last_dt, t_target, sp=None):
            states = tuple(states)
            clock = graphs.clock(self.device, t, last_dt, t_target)
            if (graphs.on_one_card(states) and self.cfg0.kernels != "off"
                    and not tracing.eager()):
                key = graphs.key(K, sp)
                if key not in self._graphs:
                    self._graphs[key] = graphs.ChunkGraph(
                        lambda st, c, s: self._chunk(st, *c, s, K),
                        (states, clock, sp), name=f"hierarchy step x{K}")
                return self._graphs[key]((states, clock, sp))
            return self._chunk(states, *clock, sp, K)

        return run_k

    # -- snapshots / restart (reference: every snapshot is a full restart
    # file with one mesh per level, dataIO/dataio_silo.h:67) ---------------
    def _stacked_state(self) -> Optional[np.ndarray]:
        """The levels' states, stacked (a sharded level gathered): what a
        snapshot holds, on one mesh or none, in either package.  On a mesh
        of several processes they are gathered to rank 0 (None on the
        others)."""
        levels = [gather(p, dst=0) for p in self.P]
        if any(p is None for p in levels):
            return None
        return torch.stack(levels).detach().cpu().numpy()

    def _header_cfg(self) -> SimConfig:
        return self.cfg0.with_(nlevels=self.n_levels, ng_centre=self.centre)

    def save(self, path: Optional[str] = None, wait: bool = True) -> str:
        """Write a snapshot of every level (``wait=False``: queued on the
        background writer).  On a mesh of several processes only rank 0
        writes, the levels gathered to it (with ``wait`` every rank returns
        once it is written)."""
        if path is None:
            if not self.outfile:
                raise ValueError("set NGHierarchy.outfile or pass a path")
            path = f"{self.outfile}.{self.step_count:08d}"
        extra = {"params": self.params} if self.params else None
        state = self._stacked_state()
        if wait:
            from .io import save_snapshot

            self.flush_io()
            if state is not None:   # (else another process writes it)
                path = save_snapshot(path, state, self._header_cfg(), self.t,
                                     self.step_count, extra=extra)
            if self.mesh is not None:
                self.mesh.barrier()     # the file is there for every rank
            return path
        if state is None:
            return path
        if self._writer is None:
            from .io.snapshot import AsyncSnapshotWriter

            self._writer = AsyncSnapshotWriter()
        self._writer.submit(path, state, self._header_cfg(), self.t,
                            self.step_count, extra)
        return path

    def flush_io(self):
        if self._writer is not None:
            self._writer.wait()

    @classmethod
    def restart(cls, path: str, physics=None, **kw) -> "NGHierarchy":
        """Resume from a multi-level snapshot.  If the snapshot header
        carries the original parameter section and no ``physics`` is given,
        the full Physics (chemistry/RT/winds) is rebuilt from it
        (reference: sim_init.cpp:173-321 rebuilds MP/RT/winds from the
        header registry).  ``mesh=`` splits the levels over a mesh
        (a snapshot holds the gathered levels, whatever wrote it; on a mesh
        of several processes every rank reads the file and keeps its
        blocks)."""
        from .io.snapshot import load_snapshot_raw

        cfg, P, t, step, extra = load_snapshot_raw(path)
        params = (extra or {}).get("params")
        if physics is None and params:
            from .cli import physics_from_params

            physics = physics_from_params(cfg, params)
        hier = cls(cfg, physics=physics, **kw)
        hier.t = t
        hier.step_count = step
        hier.params = params
        hier.set_states(list(P) if cfg.nlevels > 1 else [P])
        return hier

    def _maybe_output(self):
        if self.outfile is None:
            return
        if self.opfreq and self.step_count % self.opfreq == 0:
            self.save(wait=False)
        if self.opfreq_time > 0.0:
            if self._next_optime is None:
                self._next_optime = self.t + self.opfreq_time
            if self.t >= self._next_optime:
                while self._next_optime <= self.t:
                    self._next_optime += self.opfreq_time
                self.save(wait=False)
        if self.checkpoint_freq and \
                self.step_count % self.checkpoint_freq == 0:
            suffix = 999999 - self._ckpt_flip
            self._ckpt_flip ^= 1
            self.save(f"{self.outfile}.{suffix}", wait=False)

    def run(self, tmax: Optional[float] = None, max_steps: int = 10**9,
            chunk: int = 1):
        """Advance to ``tmax`` or by ``max_steps`` hierarchy steps.

        ``chunk`` > 1 takes that many steps at a time through
        :meth:`_multi_step_fn` when there is no timed output and the output,
        checkpoint and log cadences are multiples of the chunk (the JAX
        package's gate, ng.py:992-995): one CUDA
        graph replay on the card (on a mesh: every shard on one card), the
        same steps eagerly with ``kernels="off"``, on the CPU or on a mesh
        over several devices.  A chunk ends early at ``tmax``;
        ``max_steps`` is never passed; a run with winds takes its first step
        alone (the first-step wind cap).  The result equals the run without
        ``chunk`` bit for bit, but that evolving sources are taken once a
        chunk (as the JAX package does, ng.py:1005-1007)."""
        tmax = self.cfgs[0].tmax if tmax is None else tmax
        self._tmax = tmax
        logger = StepLogger(self.log_freq)
        chunked = (chunk > 1 and self.opfreq_time == 0.0
                   and self.opfreq % chunk == 0
                   and self.checkpoint_freq % chunk == 0
                   and (self.log_freq == 0 or self.log_freq % chunk == 0))
        while self.t < tmax * (1 - 1e-12) and self.step_count < max_steps:
            if (chunked and self.step_count + chunk <= max_steps
                    and not (self.step_count == 0
                             and self.physics is not None
                             and self.physics.wind_sources)):
                with tracing.span("run.chunk"):
                    with tracing.span("run.sources"):
                        sp = self._sources()
                    states, info = self._multi_step_fn(chunk)(
                        self.P, self.t, self.last_dt, tmax, sp)
                    with tracing.span("run.readback"):
                        dts, live = info.tolist()   # the chunk's one read-back
                    n = int(sum(live))
                    if n == 0:
                        break
                    self.P = list(states)
                    for d in dts[:n]:
                        self.t += d
                    self.last_dt = dt = dts[n - 1]
                    self.step_count += n
            else:
                # fused dt+advance (dt capped to tmax / output times)
                dt = self.step()
            self._maybe_output()
            logger.log(self.step_count, self.t, dt, self.P[0])
        if self.device.type == "cuda":
            for dev in ({self.device} if self.mesh is None
                        else self.mesh.local_devices()):
                torch.cuda.synchronize(dev)
        if self.outfile is not None:
            self.save()
        self.flush_io()
        return self
