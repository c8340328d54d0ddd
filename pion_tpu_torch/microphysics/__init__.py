"""Microphysics: non-equilibrium chemistry, heating and cooling.

Module registry mirrors the reference dispatch
(reference: source/grid/setup_fixed_grid.cpp:270-410 setup_microphysics).
Ported so far: MPv3 and the cooling-only module.  The other modules of the
JAX package are queued in ROADMAP.md, item A18; asking for one of them says
so.
"""
from .cooling import CoolingConfig, MPOnlyCooling  # noqa: F401
from .mpv3 import MPv3, MPv3Config  # noqa: F401

_NOT_PORTED = ("MPv5", "MPv6", "MPv7", "MPv8")

__all__ = ["CoolingConfig", "MPOnlyCooling", "MPv3", "MPv3Config"]


def __getattr__(name):
    if name in _NOT_PORTED:
        raise ImportError(
            f"pion_tpu_torch.microphysics.{name} is not ported yet "
            "(ROADMAP.md, queue A item 18: the other microphysics modules)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
