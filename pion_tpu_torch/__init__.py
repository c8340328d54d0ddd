"""pion_tpu_torch: the PyTorch/CUDA port of the pion_tpu finite-volume MHD
framework, for NVIDIA Hopper GPUs.

Plain tensor code is PyTorch; the fused kernels are CUDA C++ under ``csrc/``,
built at first use.  Ported so far: Cartesian MHD and GLM-MHD dynamics
(HLL/HLLD, Falle viscosity, tracers), MPv3 chemistry (:mod:`.microphysics`),
point-source and parallel-ray raytracing (:mod:`.raytracing`), stellar-wind
internal boundaries (:mod:`.winds`), their coupling (:mod:`.physics`) and
snapshots (:mod:`.io`), driven by :class:`Simulation` on one grid and by
:class:`NGHierarchy` on a static nested grid.
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
