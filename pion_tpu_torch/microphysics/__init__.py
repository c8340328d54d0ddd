"""Microphysics: non-equilibrium chemistry, heating and cooling.

Module registry mirrors the reference dispatch
(reference: source/grid/setup_fixed_grid.cpp:270-410 setup_microphysics).
"""
from .mpv3 import MPv3, MPv3Config  # noqa: F401
from .cooling import MPOnlyCooling, MPv8  # noqa: F401
from .mpv7 import MPv7  # noqa: F401
from .variants import MPv5, MPv6  # noqa: F401
