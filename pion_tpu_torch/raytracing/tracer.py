"""Short-characteristics raytracing as wavefront sweeps.

Counterpart of the reference raytracer (reference:
source/raytracing/raytracer_SC.cpp).  The reference walks cells outward from
the source in strict per-octant order — a pointer-chasing, inherently serial
sweep (raytracer_SC.cpp:1543-1562).  With the C2Ray upstream interpolation
(Mellema et al. 2006 eq. A5; reference: interpolate_2D/interpolate_3D at
raytracer_SC.cpp:2627-2682) a cell depends only on cells nearer the source,
so the sweep can run shell by shell:

- :class:`PointSourceTracer` sweeps L1 shells (|di|+|dj|+|dk| = const) with
  gathers and scatters on flat arrays.  It serves 1D grids and is the oracle
  the other tracers are tested against.
- :class:`PointSourcePlaneTracer` sweeps Chebyshev shells
  max(|di|,|dj|,|dk|) = m, face by face (2D and 3D).  Its work is done by
  :mod:`.fused_trace`: a CUDA kernel for a CUDA tensor, the plain plane sweep
  otherwise.

Sources at infinity (axis-parallel rays) reduce to a plain cumulative sum
(reference: raytracer_USC_infinity::trace_column_parallel,
raytracer_SC.cpp:716-753).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..grid import Geometry


@dataclasses.dataclass(frozen=True)
class StarEvolution:
    """Time-interpolated radiation-source properties from a stellar-
    evolution table (reference: setup_fixed_grid.cpp:595-688
    setup_evolving_RT_sources reads 'time M L Teff Mdot vrot vcrit vinf'
    and stores log10 L/T/R; update_evolving_RT_sources:695-790 linearly
    interpolates the logs in time and re-applies when L or T move >1%)."""

    time: np.ndarray      # s
    log_L: np.ndarray     # log10 L [erg/s]
    log_T: np.ndarray     # log10 Teff [K]
    log_R: np.ndarray     # log10 R* [cm]

    @classmethod
    def from_file(cls, path: str) -> "StarEvolution":
        SIGMA_SB = 5.670367e-5  # reference: constants.h StefanBoltzmannConst
        rows = []
        with open(path) as f:
            for line in f.readlines()[2:]:
                parts = line.split()
                if len(parts) >= 4:
                    rows.append([float(x) for x in parts[:4]])
        if not rows:
            raise ValueError(f"no data rows in evolution file {path}")
        a = np.asarray(rows)
        time, lum, teff = a[:, 0], a[:, 2], a[:, 3]
        rstar = np.sqrt(lum / (4.0 * np.pi * SIGMA_SB * teff**4))
        return cls(time=time, log_L=np.log10(lum), log_T=np.log10(teff),
                   log_R=np.log10(rstar))

    def at(self, t: float):
        """(L [erg/s], Teff [K], Rstar [cm]) at time t — log-linear
        interpolation, clamped to the table ends (the reference holds the
        last line constant past the end)."""
        lL = float(np.interp(t, self.time, self.log_L))
        lT = float(np.interp(t, self.time, self.log_T))
        lR = float(np.interp(t, self.time, self.log_R))
        return 10.0 ** lL, 10.0 ** lT, 10.0 ** lR


@dataclasses.dataclass(frozen=True)
class Source:
    """Radiation source (reference: raytracing/rad_src_data.h:27-76)."""

    position: Tuple[float, ...] = ()   # physical position, array order
    at_infinity: bool = False
    axis: int = -1                     # for at_infinity: array axis of rays
    sign: int = 1                      # +1: rays travel toward +axis
    strength: float = 0.0              # Ndot [1/s] or flux [1/cm^2/s]
    effect: str = "mono"               # mono | mfion | uv_heating
    tau_min: float = 0.7               # C2Ray interpolation floor
    # stellar-evolution table driving (strength, Teff, Rstar) in time
    # (reference: rad_src_info.EvoFile, rad_src_data.h:66)
    evolution: Optional[StarEvolution] = None
    # per-source stellar properties for mfion (reference:
    # rad_src_info.Tstar/Rstar, rad_src_data.h:44-46) — 0 means "use the
    # chemistry module's setup-time table"
    tstar: float = 0.0
    rstar_cm: float = 0.0


def parallel_rays(dtau: torch.Tensor, axis: int, sign: int, dx: float):
    """Column densities for a source at infinity: tau at cell entry is the
    exclusive cumulative sum of per-cell dtau along the ray direction."""
    if sign > 0:
        cum = torch.cumsum(dtau, dim=axis)
    else:
        cum = torch.flip(torch.cumsum(torch.flip(dtau, (axis,)), dim=axis),
                         (axis,))
    tau_entry = cum - dtau
    ds = torch.full_like(dtau, dx)
    vshell = ds  # reference: set_Vshell_in_cell for at_infinity (:2697-2703)
    return tau_entry, ds, vshell


def _source_geometry(cfg: SimConfig, geom: Geometry, pos):
    """What both point-source tracers derive from the source position, in
    numpy at float64: the source cell, integer offsets, the major axis of
    every cell (largest |offset|, ties preferring x, then y, then z), path
    length through the cell and shell volume."""
    nd = cfg.ndim
    shape = cfg.shape
    dx = geom.dx
    ng = cfg.ng
    centers = [g.pos[ng:-ng] for g in geom.axes]
    src_idx = [int(np.clip(np.argmin(np.abs(centers[a] - pos[a])),
                           0, shape[a] - 1)) for a in range(nd)]
    grids = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    d = [g - s for g, s in zip(grids, src_idx)]         # integer offsets
    ad = [np.abs(x) for x in d]
    p = sum(ad)
    # compare from the fast axis backwards (x is the LAST array axis),
    # matching the reference's diffx>=diffy ordering
    order = list(range(nd - 1, -1, -1))
    maj = np.full(shape, order[0])
    best = ad[order[0]].copy()
    for a in order[1:]:
        take = ad[a] > best
        maj = np.where(take, a, maj)
        best = np.where(take, ad[a], best)
    # path length through cell: ds = dx*sqrt(1+sum(delta_i^2))
    deltas = [np.where(best > 0, adk / np.maximum(best, 1), 0.0)
              for adk in ad]
    sum_d2 = sum(dk * dk for dk in deltas) - 1.0     # remove the major axis
    ds = dx * np.sqrt(1.0 + np.maximum(sum_d2, 0.0))
    ds = np.where(p == 0, 0.5 * dx, ds)
    # shell volume (reference: set_Vshell_in_cell:2690-2721)
    r_cell = np.sqrt(sum((dd * dx) ** 2 for dd in d))
    rs = np.maximum(r_cell - 0.5 * ds, 0.0)
    vshell = 4.0 * np.pi * ((rs + ds) ** 3 - rs**3) / 3.0
    src_pos = np.array([centers[a][src_idx[a]] for a in range(nd)])
    return dict(src_idx=tuple(src_idx), src_pos=src_pos, grids=grids, d=d,
                ad=ad, p=p, maj=maj, best=best, deltas=deltas, ds=ds,
                vshell=vshell)


class PointSourceTracer:
    """Point-source short-characteristics tracer for one source position,
    L1 shell by L1 shell.

    All geometry (shell ordering, upstream neighbour indices, interpolation
    weights, path lengths, shell volumes) is precomputed in numpy at setup;
    :meth:`trace` is a loop over shells on flat column arrays.
    """

    def __init__(self, cfg: SimConfig, geom: Geometry, pos: Tuple[float, ...],
                 tau_min: float = 0.7):
        self.cfg = cfg
        self.tau_min = tau_min * (6.0 / 7.0 if cfg.ndim == 3 else 1.0)
        nd = cfg.ndim
        shape = cfg.shape
        g = _source_geometry(cfg, geom, pos)
        self.src_idx = g["src_idx"]
        self.src_pos = g["src_pos"]
        self.ds = g["ds"]
        self.vshell = g["vshell"]
        grids, d, ad, p = g["grids"], g["d"], g["ad"], g["p"]
        maj, best, deltas = g["maj"], g["best"], g["deltas"]
        sgn = [np.sign(x).astype(int) for x in d]

        # upstream neighbour flat indices (c1: entry-face neighbour on the
        # major axis; c2/c3: c1 shifted toward the source on the
        # perpendicular axes; c4: double-diagonal)
        flat = np.arange(int(np.prod(shape))).reshape(shape)

        def shift_idx(offsets):
            idx = [np.clip(grids[a] - offsets[a], 0, shape[a] - 1)
                   for a in range(nd)]
            return flat[tuple(idx)]

        off_major = [np.where(maj == a, sgn[a], 0) for a in range(nd)]
        cols = [shift_idx(off_major)]
        wts = []
        if nd == 2:
            off_p1 = [off_major[a] + np.where(maj != a, sgn[a], 0)
                      for a in range(nd)]
            cols.append(shift_idx(off_p1))
            mino = np.minimum(ad[0], ad[1])
            wts.append(np.where(best > 0, mino / np.maximum(best, 1), 0.0))
        elif nd == 3:
            # "first"/"second" per cell: the two non-major axes in
            # increasing axis order
            firsts = [[b for b in range(nd) if b != a][0] for a in range(nd)]
            seconds = [[b for b in range(nd) if b != a][1] for a in range(nd)]
            first_ax = np.choose(maj, firsts)
            second_ax = np.choose(maj, seconds)
            off_c2 = [off_major[a] + np.where(first_ax == a, sgn[a], 0)
                      for a in range(nd)]
            off_c3 = [off_major[a] + np.where(second_ax == a, sgn[a], 0)
                      for a in range(nd)]
            off_c4 = [off_major[a] + np.where(maj != a, sgn[a], 0)
                      for a in range(nd)]
            cols += [shift_idx(off_c2), shift_idx(off_c3), shift_idx(off_c4)]
            wts += [np.choose(first_ax, deltas), np.choose(second_ax, deltas)]

        # on-axis correction (reference: cell_cols_2d:2181-2218): cells with
        # mindiff==0 take the entry neighbour's column scaled by a geometric
        # factor when close to the source (maxdiff<10 cells)
        if nd == 1:
            min_off = np.zeros(shape, dtype=int)
        elif nd == 2:
            min_off = np.minimum(ad[0], ad[1])
        else:
            # 3D "on axis" = both non-major offsets zero, i.e. the
            # second-largest offset vanishes
            min_off = np.sort(np.stack(ad), axis=0)[1]
        on_axis = (min_off == 0) & (p > 0)
        m = best.astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.sqrt((m * m + 0.25) / ((m - 1) ** 2 + 0.25)) * \
                np.where(m > 0, (m - 1) / np.maximum(m, 1), 0.0)
        corr = np.where((m < 10) & (m >= 1), corr, 1.0)
        if nd == 1:
            corr = np.ones_like(corr)  # 1D rays: plain accumulation
        self.on_axis = on_axis
        self.axis_corr = np.where(on_axis, corr, 1.0)

        # shells: flat cell indices grouped by p, and every per-cell array
        # ordered the same way, so that a shell is one contiguous slice
        pf = p.ravel()
        order_cells = np.argsort(pf, kind="stable")
        self.n_shells = int(pf.max()) + 1
        counts = np.bincount(pf, minlength=self.n_shells)
        self._bounds = np.concatenate([[0], np.cumsum(counts)])
        self._order = order_cells
        self._cols = [c.ravel()[order_cells] for c in cols]
        self._wts = [w.ravel()[order_cells] for w in wts]
        self._oa = on_axis.ravel()[order_cells]
        self._corr = self.axis_corr.ravel()[order_cells]
        self._packed = {}

    def _tensors(self, like: torch.Tensor):
        key = (like.dtype, like.device)
        if key not in self._packed:
            dev = like.device
            self._packed[key] = dict(
                order=torch.as_tensor(self._order, device=dev),
                cols=[torch.as_tensor(c, device=dev) for c in self._cols],
                wts=[torch.as_tensor(w, dtype=like.dtype, device=dev)
                     for w in self._wts],
                oa=torch.as_tensor(self._oa, device=dev),
                corr=torch.as_tensor(self._corr, dtype=like.dtype,
                                     device=dev))
        return self._packed[key]

    def trace(self, dtau: torch.Tensor) -> torch.Tensor:
        """Run the shell loop.  ``dtau``: per-cell optical depth increment.
        Returns ``tau_entry`` (optical depth to the cell's entry point)."""
        nd = self.cfg.ndim
        dtau_f = dtau.reshape(-1)
        t = self._tensors(dtau_f)
        col = torch.zeros_like(dtau_f)
        tmin = self.tau_min
        for s in range(self.n_shells):
            sl = slice(int(self._bounds[s]), int(self._bounds[s + 1]))
            idx = t["order"][sl]
            c1 = col[t["cols"][0][sl]]
            if nd == 1:
                tau_in = c1
            elif nd == 2:
                d0 = t["wts"][0][sl]
                c2 = col[t["cols"][1][sl]]
                w1 = (1.0 - d0) / torch.clamp(c1, min=tmin)
                w2 = d0 / torch.clamp(c2, min=tmin)
                tau_in = (w1 * c1 + w2 * c2) / (w1 + w2)
            else:
                d0, d1 = t["wts"][0][sl], t["wts"][1][sl]
                c2 = col[t["cols"][1][sl]]
                c3 = col[t["cols"][2][sl]]
                c4 = col[t["cols"][3][sl]]
                w1 = (1.0 - d0) * (1.0 - d1) / torch.clamp(c1, min=tmin)
                w2 = d0 * (1.0 - d1) / torch.clamp(c2, min=tmin)
                w3 = (1.0 - d0) * d1 / torch.clamp(c3, min=tmin)
                w4 = d0 * d1 / torch.clamp(c4, min=tmin)
                tau_in = (w1 * c1 + w2 * c2 + w3 * c3 + w4 * c4) / (
                    w1 + w2 + w3 + w4)
            # on-axis cells: entry neighbour's column with geometric factor
            tau_in = torch.where(t["oa"][sl], c1 * t["corr"][sl], tau_in)
            col[idx] = tau_in + dtau_f[idx]
        return (col - dtau_f).reshape(dtau.shape)


class PointSourcePlaneTracer:
    """Cube-shell (L-inf) point-source tracer for 2D and 3D grids.

    Same C2Ray interpolation as :class:`PointSourceTracer`, reorganized: the
    sweep walks Chebyshev shells max(|di|,|dj|,|dk|) = m — at most max(N_a)
    steps — and updates the cube faces of a shell as dense plane operations.

    Correct ordering: a face cell's upstream neighbours (c1..c4) sit either
    in shell m-1 or — for edge/corner cells, whose major-axis preference is
    x>y>z — in a LOWER-preference face of the same shell; updating the faces
    in ascending array-axis order (z, then y, then x) therefore satisfies
    every dependency (the values are the ones the L1-shell loop computes,
    since each cell applies the same formula to the same upstream cells).

    The sweep itself is :func:`.fused_trace.octant_trace`: the CUDA kernel
    for a CUDA tensor and its plain version for a CPU tensor when
    ``cfg.kernels`` is "auto"; the plain plane sweep on whatever device when
    it is "off".  A 2D grid goes through as a slab one cell deep: with a
    z-offset of 0 the 3D weights reduce exactly to the 2D ones."""

    def __init__(self, cfg: SimConfig, geom: Geometry, pos: Tuple[float, ...],
                 tau_min: float = 0.7):
        if cfg.ndim < 2:
            raise ValueError("plane sweep needs >= 2 dimensions "
                             "(1D: PointSourceTracer)")
        self.cfg = cfg
        self.tau_min = tau_min * (6.0 / 7.0 if cfg.ndim == 3 else 1.0)
        g = _source_geometry(cfg, geom, pos)
        self.src_idx = g["src_idx"]
        self.src_pos = g["src_pos"]
        self.ds = g["ds"]
        self.vshell = g["vshell"]
        nd = cfg.ndim
        self.n_steps = int(max(max(self.src_idx[a],
                                   cfg.shape[a] - 1 - self.src_idx[a])
                               for a in range(nd)))

    def trace(self, dtau: torch.Tensor) -> torch.Tensor:
        """Returns tau_entry (optical depth to each cell's entry point)."""
        from . import fused_trace

        slab = self.cfg.ndim == 2
        d3 = dtau[None] if slab else dtau
        src = ((0,) + self.src_idx) if slab else self.src_idx
        if self.cfg.kernels == "off":
            col = fused_trace.octant_trace_plain(d3, src, self.tau_min)
        else:
            col = fused_trace.octant_trace(d3, src, self.tau_min)
        return (col[0] if slab else col) - dtau


class Raytracer:
    """Per-step front end: computes what the chemistry module's rt dict is
    assembled from (the RayTrace_SingleSource + rt_source_data equivalent,
    reference: sim_init.cpp:806 RT_all_sources)."""

    def __init__(self, cfg: SimConfig, geom: Geometry, sources):
        self.cfg = cfg
        self.geom = geom
        self.sources = list(sources)
        self.point_tracers = {}
        self._static = {}
        for i, s in enumerate(self.sources):
            if not s.at_infinity:
                # 2D/3D: the plane sweep; 1D keeps the L1-shell loop (two
                # trivial directional rays)
                cls = (PointSourcePlaneTracer if cfg.ndim >= 2
                       else PointSourceTracer)
                self.point_tracers[i] = cls(cfg, geom, s.position,
                                            s.tau_min)

    def static_fields(self, i: int, like: torch.Tensor):
        """``(ds, vshell)`` of point source ``i`` as tensors of ``like``'s
        dtype on its device, made once.  Raw shell volumes (~1e51 cm^3)
        leave float32: they are clipped to 3e38 there, and only serve as a
        diagnostic — rate factors use the host-side Ndot/Vshell of
        ``Physics.raytrace``."""
        key = (i, like.dtype, like.device)
        if key not in self._static:
            tr = self.point_tracers[i]
            vs = tr.vshell
            if like.dtype == torch.float32:
                vs = np.minimum(vs, 3.0e38)
            self._static[key] = tuple(
                torch.as_tensor(a, dtype=like.dtype, device=like.device)
                for a in (tr.ds, vs))
        return self._static[key]

    def trace_source(self, i: int, dtau: torch.Tensor):
        s = self.sources[i]
        if s.at_infinity:
            return parallel_rays(dtau, s.axis, s.sign, self.geom.dx)
        tau = self.point_tracers[i].trace(dtau)
        ds, vs = self.static_fields(i, dtau)
        return tau, ds, vs
