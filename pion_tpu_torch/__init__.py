"""pion_tpu_torch: the PyTorch/CUDA port of the pion_tpu finite-volume MHD
framework, for NVIDIA Hopper GPUs.

Plain tensor code is PyTorch; the fused kernels are CUDA C++ under ``csrc/``,
built at first use.  Ported so far: single-grid Cartesian MHD and GLM-MHD
dynamics (HLL/HLLD, Falle viscosity, tracers), MPv3 chemistry
(:mod:`.microphysics`), point-source and parallel-ray raytracing
(:mod:`.raytracing`) and their coupling (:mod:`.physics`), driven by
:class:`Simulation`.
"""
from .config import SimConfig
from .constants import AV, BC, Coord, Eqn, Solver
from .grid import Geometry, make_geometry
from .sim import Simulation

__version__ = "0.1.0"

__all__ = [
    "AV", "BC", "Coord", "Eqn", "Solver",
    "SimConfig", "Geometry", "make_geometry", "Simulation",
]
