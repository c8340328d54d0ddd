"""Microphysics: MPv3, the non-equilibrium chemistry with heating and
cooling that the benchmark's cells run (reference:
source/grid/setup_fixed_grid.cpp:270-410 setup_microphysics)."""
from .mpv3 import MPv3, MPv3Config  # noqa: F401
