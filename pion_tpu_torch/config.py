"""Static simulation configuration.

The reference stores run configuration in a mutable god-object ``SimParams``
(reference: source/sim_params.h:200-285).  Here configuration is an immutable,
hashable dataclass — everything that decides *code structure* (ndim, solver,
BCs, shapes, which kernel instantiation runs) lives here; everything that is
a *number the step consumes* (dt, time, the state itself) is a tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .constants import AV, BC, Coord, Eqn, Solver


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Immutable run configuration.

    Spatial axes are ordered so the x-axis (or the radial axis in curvilinear
    coords) is LAST in array shapes: 1D -> (nx,), 2D -> (ny, nx),
    3D -> (nz, ny, nx).  For 2D axisymmetric runs the axes are (R, z) in
    array order, i.e. shape (NR, Nz), with z the fast/last axis; PION calls
    these (Zcyl, Rcyl) with Z the x-axis — here ``axis 'x'``==z, ``axis 'y'``==R.
    """

    ndim: int = 1
    eqn: Eqn = Eqn.EULER
    coords: Coord = Coord.CARTESIAN
    solver: Solver = Solver.HLL
    ntracer: int = 0
    gamma: float = 5.0 / 3.0
    cfl: float = 0.3
    ooa: int = 2                      # order of accuracy (1 or 2), time & space
    av: AV = AV.NONE
    etav: float = 0.1                 # Falle AV coefficient

    # Grid: shape is in array order (slowest..fastest) == (z, y, x) reversed
    # from PION's (x, y, z).  xmin/xmax likewise in array order.
    shape: Tuple[int, ...] = (128,)
    xmin: Tuple[float, ...] = (0.0,)
    xmax: Tuple[float, ...] = (1.0,)

    # Boundary conditions per axis: ((lo, hi), ...) in array order.
    bcs: Tuple[Tuple[BC, BC], ...] = ((BC.OUTFLOW, BC.OUTFLOW),)

    # Floors (reference: SimParams.EP.MinTemperature etc.)
    min_temperature: float = 0.0
    max_temperature: float = 1.0e100
    # Reference pressure for the MHD negative-pressure floor
    # (reference: eqns_mhd_adiabatic.cpp:219 uses eq_refvec[PG]*1e-6).
    p_ref: float = 1.0
    rho_ref: float = 1.0

    # GLM divergence cleaning (reference: calc_timestep.cpp:112-139)
    glm_cr_factor: float = 0.25       # c_r = glm_cr_factor / dx_finest

    dtype: str = "float64"
    # fused CUDA sweep kernels: "auto" launches them for a CUDA tensor
    # whenever ops.fused_sweep.supports(cfg) holds (a CPU tensor always
    # takes the plain torch sweep); "off" runs the plain torch sweep on
    # whatever device the tensor is on
    kernels: str = "auto"
    # multi-device halo strategy and device-mesh execution (the
    # MCMD_boundaries / MPI-binary equivalents, main_NG_MPI.cpp:40-60).
    # Single-device only so far: Simulation raises NotImplementedError for
    # halo="explicit" and mesh="on"; "gspmd"/"auto"/"off" all mean one device
    halo: str = "gspmd"
    mesh: str = "auto"
    # HLLD->HLL switch in compressive strong-gradient zones (Mignone+ 2011;
    # reference behavior).  Disable to trade robustness for ~25% step speed.
    hlld_fallback: bool = True
    # Slavin & Cox (1992) saturated thermal conduction (reference:
    # #define THERMAL_CONDUCTION, defines/functionality_flags.h:90 —
    # off by default upstream too)
    conduction: bool = False

    # time control
    tmax: float = 1.0
    min_timestep: float = 1.0e-30
    max_dt_growth: float = 1.3        # reference: calc_timestep.cpp:239

    # Nested-grid hierarchy (reference: sim_params.h:232-238 grid_nlevels /
    # NG_centre; level extents per setup_NG_grid.cpp:88-160).  ``ng_centre``
    # is the refinement centre in ARRAY axis order; levels above 0 carry
    # nlevels=1 (the hierarchy object owns the stack).
    nlevels: int = 1
    ng_centre: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        # Coerce string shorthands to enums (str-valued enums compare equal
        # but identity checks need the real members).
        object.__setattr__(self, "eqn", Eqn(self.eqn))
        object.__setattr__(self, "coords", Coord(self.coords))
        object.__setattr__(self, "solver", Solver(self.solver))
        object.__setattr__(self, "av", AV(self.av))
        object.__setattr__(
            self,
            "bcs",
            tuple((BC(lo), BC(hi)) for lo, hi in self.bcs),
        )
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "xmin", tuple(float(v) for v in self.xmin))
        object.__setattr__(self, "xmax", tuple(float(v) for v in self.xmax))
        assert 1 <= self.ndim <= 3
        assert len(self.shape) == self.ndim
        assert len(self.xmin) == self.ndim and len(self.xmax) == self.ndim
        assert len(self.bcs) == self.ndim
        assert self.ooa in (1, 2)
        if self.coords is Coord.CYLINDRICAL:
            assert self.ndim == 2, "axisymmetric cylindrical grid is 2D (R,z)"
        if self.coords is Coord.SPHERICAL:
            assert self.ndim == 1, "spherical grid is 1D (r)"
        assert self.nlevels >= 1
        if self.kernels not in ("auto", "off"):
            raise ValueError(
                f"kernels must be 'auto' or 'off', got {self.kernels!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"dtype must be 'float32' or 'float64', got {self.dtype!r}")
        # square/cubic cells, like the reference (uniform_grid.cpp asserts
        # equal Range/NG per axis); a mismatched domain would silently use
        # the minor-axis dx for every axis
        dxs = [(hi - lo) / n
               for lo, hi, n in zip(self.xmin, self.xmax, self.shape)]
        if max(dxs) - min(dxs) > 1.0e-10 * max(dxs):
            raise ValueError(
                f"cells must be square/cubic: per-axis dx {dxs}; choose "
                "xmin/xmax so (xmax-xmin)/n is equal on every axis")
        if self.ng_centre is not None:
            object.__setattr__(
                self, "ng_centre",
                tuple(float(v) for v in self.ng_centre))
            assert len(self.ng_centre) == self.ndim
        elif self.nlevels > 1:
            # default: domain centre (co-centred nesting)
            object.__setattr__(
                self, "ng_centre",
                tuple(0.5 * (lo + hi)
                      for lo, hi in zip(self.xmin, self.xmax)))

    # -- derived quantities ------------------------------------------------
    @property
    def nvar(self) -> int:
        return self.eqn.nbase + self.ntracer

    @property
    def tracer_slice(self) -> slice:
        return slice(self.eqn.nbase, self.nvar)

    @property
    def dx(self) -> float:
        """Cell size (uniform & equal in all directions, like the reference)."""
        return (self.xmax[-1] - self.xmin[-1]) / self.shape[-1]

    @property
    def ng(self) -> int:
        """Ghost-zone depth: 2 for 2nd-order MUSCL stencils."""
        return 2

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self):
        import torch

        return torch.float32 if self.dtype == "float32" else torch.float64

    def with_(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    # positions -----------------------------------------------------------
    def cell_centers(self, axis: int, padded: bool = False) -> np.ndarray:
        """1D array of cell-center coordinates along ``axis`` (array order)."""
        n = self.shape[axis]
        dx = self.dx
        lo = self.xmin[axis]
        idx = np.arange(-self.ng, n + self.ng) if padded else np.arange(n)
        return (lo + (idx + 0.5) * dx).astype(self.np_dtype)
