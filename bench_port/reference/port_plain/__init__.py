"""A frozen copy of the plain path of ``pion_tpu_torch`` (its Python sources
at the commit that added this benchmark), trimmed to what the benchmark's
cells run: the reference that decides a cell's ``correct``.

It runs with ``kernels="off"`` only: plain PyTorch, no CUDA kernel and no
CUDA graph, one step at a time, on one device.  Kept: the GLM-MHD sweep with
HLLD (HLL where it falls back) and Falle viscosity on Cartesian grids, the
periodic, outflow, inflow and fixed faces, the timestep, the nested-grid
glue, stellar winds, MPv3 chemistry and the point-source trace.  Imports
nothing of the program: a later change to ``pion_tpu_torch`` does not move
the reference.
"""
from .config import SimConfig
from .constants import AV, BC, Coord, Eqn, Solver
from .grid import Geometry, make_geometry
from .ng import NGHierarchy
from .sim import Simulation
from .winds import WindSource

__version__ = "0.1.0"

__all__ = [
    "AV", "BC", "Coord", "Eqn", "Solver",
    "SimConfig", "Geometry", "make_geometry", "Simulation", "NGHierarchy",
    "WindSource",
]
