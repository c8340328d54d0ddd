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
time-averaged sum of fine fluxes.

The methods run eagerly, one PyTorch operation after another.  ``dt``,
the cleaning speed ``ch`` of each level and the half steps stay 0-d tensors
on the device through the whole recursion; a step reads one number back,
the ``dt`` it took.  No method writes into a state it was given: the
corrector reads the start-of-step state again after the predictor, both
child substeps read the parent's half-step state, and the restriction reads
the child after both.  The only in-place write is the BC89 addition into
the corrector's own fresh ``dU``.

Prolongation, restriction, BC89, the interface slabs and every level's
sweeps are plain PyTorch.  The program's kernels, chunks, meshes and
snapshots, and fine levels that touch the domain's faces, are left out of
this copy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .boundaries import apply_bcs, make_fixed_strips
from .config import SimConfig
from .constants import Coord, Eqn
from .grid import make_geometry
from .ops.eqns import cons_to_prim, prim_to_cons
from .ops.recon import van_albada
from .ops.sweep import dynamics_dU
from .ops.timestep import dynamics_dt
from .stepper import (_scma_flag, cell_advance, glm_psi_damp, later,
                      limit_dt)
from .utils import resolve_device

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


class NGHierarchy:
    """Holds per-level state and advances the stack recursively.

    ``device``: the CUDA device when None (raising if there is none), the
    CPU only when the caller asks for it.  ``cfg.conduction`` is not read,
    as the program's hierarchy does not read it."""

    def __init__(self, cfg0: SimConfig, n_levels: Optional[int] = None,
                 states: Optional[List] = None, physics=None, device=None):
        if n_levels is None:
            n_levels = cfg0.nlevels
        if cfg0.kernels != "off":
            raise NotImplementedError(
                "the reference steps the plain path (kernels='off')")
        self.device = resolve_device(device)
        self.n_levels = n_levels
        self.cfg0 = cfg0
        self.centre = snap_ng_centre(cfg0)
        self.cfgs = [make_level_cfg(cfg0, l, self.centre)
                     for l in range(n_levels)]
        self.geoms = [make_geometry(c) for c in self.cfgs]

        # per-level child window in PARENT cell indices: level l>=1 covers
        # parent cells [offs[l][ax], offs[l][ax] + n//2) on each axis
        self.offs: List[Optional[Tuple[int, ...]]] = [None]
        # every fine level's faces get C2F prolongation ghosts
        for l in range(1, n_levels):
            cfg_c, cfg_f = self.cfgs[l - 1], self.cfgs[l]
            offs = []
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
                if (np.isclose(cfg_f.xmin[ax], cfg0.xmin[ax])
                        or np.isclose(cfg_f.xmax[ax], cfg0.xmax[ax])):
                    raise NotImplementedError(
                        f"level {l} touches the domain's face on axis "
                        f"{ax}: left out of this copy")
            self.offs.append(tuple(offs))

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

    def set_states(self, states):
        """Each level's state: tensors or arrays."""
        if len(states) != self.n_levels:
            raise ValueError(f"{len(states)} states for {self.n_levels} "
                             f"levels")
        dtype = self.cfg0.torch_dtype
        # the strips of the frozen faces are taken from the states as given,
        # on the host, before they are cast
        host = [s.detach().cpu().numpy() if isinstance(s, torch.Tensor)
                else np.asarray(s) for s in states]
        expect = (self.cfg0.nvar,) + self.cfg0.shape
        for l, s in enumerate(host):
            if s.shape != expect:
                raise ValueError(f"level {l} state shape {s.shape} != "
                                 f"{expect}")
        self.P = [torch.as_tensor(s).to(dtype=dtype, device=self.device)
                  .contiguous() for s in host]
        self.bdata = make_fixed_strips(
            host[0].astype(self.cfg0.np_dtype), self.cfgs[0])
        for l in range(self.n_levels):
            if self.phys[l] is not None and self.phys[l].winds:
                self.P[l] = self.phys[l].apply_internal_bcs(self.P[l],
                                                            self.t)

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

    def _pad_level(self, level: int, Ph, parent_state):
        """Padded state for level: domain BCs at level 0; C2F ghosts from
        the parent otherwise.  The result is a new contiguous tensor."""
        cfg = self.cfgs[level]
        if level == 0:
            return apply_bcs(Ph, cfg, self.bdata)
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

    # -- F2C restriction ---------------------------------------------------
    def _restrict(self, Pc, Pf, level_f: int):
        """Replace covered coarse cells with the VOLUME-WEIGHTED
        conserved-variable average of their 2^ndim children (reference:
        NG_fine_to_coarse_boundaries.cpp:255-320 average_cells —
        sum(U*vol)/sum(vol); exact for cylindrical/spherical metrics).
        Returns a new tensor; neither ``Pc`` nor ``Pf`` is written."""
        cfg_c = self.cfgs[level_f - 1]
        nd = cfg_c.ndim
        off = self.offs[level_f]
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
        taus = phys.trace_taus(Ph, tau_in)
        out = {}
        for i in inf_idx:
            s = phys.sources[i]
            ax = s.axis
            idx = (off_c[ax] if s.sign > 0
                   else off_c[ax] + cfg.shape[ax] // 2 - 1)
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

    def _advance_level(self, level: int, dt, parent_state=None,
                       tau_in=None, t0=None, states=None, sp=None,
                       rt0_map=None):
        """One OA2 step of `level` with two recursive substeps of level+1.
        Returns the time-summed restricted boundary-plane fluxes for the
        parent's BC89 correction (reference: sim_control_NG.cpp:679-810).
        ``tau_in``: per-source upstream column offsets handed down by the
        parent (sources at infinity only).  ``states``: the list the
        recursion reads and rebinds entries of (never the tensors in it);
        defaults to ``self.P``.  ``dt`` is a number or a 0-d tensor."""
        if states is None:
            states = self.P
        cfg = self.cfgs[level]
        geom = self.geoms[level]
        phys = self.phys[level]
        P = states[level]
        scma = _scma_flag(phys)
        glm = cfg.eqn is Eqn.GLM
        ch = cfg.cfl * geom.dx / dt if glm else None
        if t0 is None:
            t0 = self.t

        # predictor half-step (1st-order space)
        Ppad = self._pad_level(level, P, parent_state)
        dU_h, _ = dynamics_dU(Ppad, cfg, geom, 0.5 * dt, 1, ch=ch,
                              scma=scma)
        if phys is not None and phys.mp is not None:
            # reuse the columns traced through this pre-step state by the
            # fused dt computation, when available (first touch per level)
            rt_pre = (rt0_map or {}).get(level)
            dU_h = dU_h + phys.mp_delta_U(P, P, 0.5 * dt, cfg, tau_in,
                                          sp=sp, rt=rt_pre)
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

        # corrector (2nd-order space); the sweep keeps its face fluxes for
        # BC89 and the boundary restriction
        Ppad = self._pad_level(level, Ph, parent_state)
        dU_f, faces = dynamics_dU(Ppad, cfg, geom, dt, 2, ch=ch, scma=scma)

        def get_face(ax_, i_):
            return faces[ax_].select(1 + ax_, i_)

        if phys is not None and phys.mp is not None:
            dU_f = dU_f + phys.mp_delta_U(P, Ph, dt, cfg, tau_in,
                                          sp=sp)

        # second fine substep
        fine_sums_2 = None
        if level + 1 < self.n_levels:
            fine_sums_2 = self._advance_level(level + 1, 0.5 * dt, Ph,
                                              tau_child, later(t0, 0.5 * dt),
                                              states, sp)

        # BC89: correct this level's dU with the fine fluxes
        if level + 1 < self.n_levels:
            sums = []
            for ax in range(cfg.ndim):
                lo = 0.5 * (fine_sums_1[ax][0] + fine_sums_2[ax][0])
                hi = 0.5 * (fine_sums_1[ax][1] + fine_sums_2[ax][1])
                sums.append((lo, hi))
            dU_f = self._bc89_correct(dU_f, get_face, sums, level, dt)

        P_new = cell_advance(P, dU_f, cfg)
        if glm:
            P_new = glm_psi_damp(P_new, dt, ch, cfg, geom)
        if phys is not None and phys.mp is not None:
            # temperature ceiling (reference: grid_update_state_vector
            # clamps, time_integrator.cpp:881-940)
            T = phys.mp.temperature(P_new, cfg)
            P_new = torch.where(T > cfg.max_temperature,
                                phys.mp.set_temp(P_new, cfg.max_temperature,
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

    def _dt_cap(self) -> float:
        """End-time ceiling (reference:
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
        ``t``, ``last_dt`` and ``cap`` are host numbers.  Returns the new states and the 0-d
        ``dt``, unread."""
        rt0_map: Dict = {}
        dtv = self._level_dt(states, sp, rt0_map)
        dtv = limit_dt(dtv, last_dt, cap, self.cfgs[0].max_dt_growth)
        states = list(states)
        self._advance_level(0, dtv, t0=t, states=states, sp=sp,
                            rt0_map=rt0_map)
        return states, dtv

    def run(self, tmax: Optional[float] = None, max_steps: int = 10**9):
        """Advance to ``tmax`` or by ``max_steps`` hierarchy steps, one
        step at a time."""
        tmax = self.cfgs[0].tmax if tmax is None else tmax
        self._tmax = tmax
        while self.t < tmax * (1 - 1e-12) and self.step_count < max_steps:
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self
