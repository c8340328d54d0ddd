"""Short-characteristics raytracing as wavefront sweeps.

Counterpart of the reference raytracer (reference:
source/raytracing/raytracer_SC.cpp).  The reference walks cells outward from
the source in strict per-octant order — a pointer-chasing, inherently serial
sweep (raytracer_SC.cpp:1543-1562).  With the C2Ray upstream interpolation
(Mellema et al. 2006 eq. A5; reference: interpolate_2D/interpolate_3D at
raytracer_SC.cpp:2627-2682) a cell depends only on cells nearer the source,
so the sweep can run shell by shell:

- :class:`PointSourcePlaneTracer` sweeps Chebyshev shells
  max(|di|,|dj|,|dk|) = m, face by face (2D and 3D), with the plain plane
  sweep of :mod:`.fused_trace`.

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


class PointSourcePlaneTracer:
    """Cube-shell (L-inf) point-source tracer for 2D and 3D grids.

    The C2Ray short-characteristics interpolation: the sweep walks Chebyshev shells max(|di|,|dj|,|dk|) = m — at most max(N_a)
    steps — and updates the cube faces of a shell as dense plane operations.

    Correct ordering: a face cell's upstream neighbours (c1..c4) sit either
    in shell m-1 or — for edge/corner cells, whose major-axis preference is
    x>y>z — in a LOWER-preference face of the same shell; updating the faces
    in ascending array-axis order (z, then y, then x) therefore satisfies
    every dependency (the values are the ones the L1-shell loop computes,
    since each cell applies the same formula to the same upstream cells).

    The sweep itself is :func:`.fused_trace.octant_trace_plain`, the plain
    plane sweep (the program's kernel is left out of this copy).  A 2D grid
    goes through as a slab one cell deep: with a
    z-offset of 0 the 3D weights reduce exactly to the 2D ones."""

    def __init__(self, cfg: SimConfig, geom: Geometry, pos: Tuple[float, ...],
                 tau_min: float = 0.7):
        if cfg.ndim < 2:
            raise ValueError("plane sweep needs >= 2 dimensions (the 1D "
                             "tracer is left out of this copy)")
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
        col = fused_trace.octant_trace_plain(d3, src, self.tau_min)
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
                self.point_tracers[i] = PointSourcePlaneTracer(
                    cfg, geom, s.position, s.tau_min)

    def static_fields(self, i: int, like: torch.Tensor):
        """``(ds, vshell)`` of point source ``i`` as tensors of ``like``'s
        dtype on its device, made once.  Raw shell
        volumes (~1e51 cm^3) leave float32: they are clipped to 3e38 there,
        and only serve as a diagnostic — rate factors use the host-side
        Ndot/Vshell of ``Physics.raytrace``."""
        key = (i, like.dtype, like.device)
        if key not in self._static:
            tr = self.point_tracers[i]
            ds, vs = tr.ds, tr.vshell
            if like.dtype == torch.float32:
                vs = np.minimum(vs, 3.0e38)
            self._static[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), dtype=like.dtype,
                                device=like.device) for a in (ds, vs))
        return self._static[key]

    def trace_source(self, i: int, dtau: torch.Tensor):
        s = self.sources[i]
        if s.at_infinity:
            return parallel_rays(dtau, s.axis, s.sign, self.geom.dx)
        tau = self.point_tracers[i].trace(dtau)
        ds, vs = self.static_fields(i, dtau)
        return tau, ds, vs
