"""Common microphysics interface.

The reference defines the module interface in microphysics_base
(reference: source/microphysics/microphysics_base.h:52-318): TimeUpdateMP /
TimeUpdateMP_RTnew, timescales(_RT), Temperature, Set_Temp.  Here the
interface is duck-typed (update / timescales / temperature / set_temp);
:class:`MicrophysicsBase` supplies the two public entry points for modules
that implement ``_update_impl`` / ``_timescales_impl``.  PyTorch runs
eagerly, so there is nothing to compile or cache.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..config import SimConfig


class MicrophysicsBase:
    """Mixin: ``update`` and ``timescales`` with the no-raytracer default."""

    # absolute primitive-vector indices of ELEMENT mass-fraction tracers
    # (reference: microphysics_base el_index); the sCMA corrector
    # renormalizes these to sum to 1 at the advection edge states
    # (microphysics_base.cpp:96-118).  Empty for the single-ion H modules.
    element_slots: tuple = ()

    def update(self, P, dt, cfg: SimConfig, rt: Optional[Dict] = None):
        if rt is None:
            rt = self.default_rt(P)
        return self._update_impl(P, dt, cfg, rt)

    def timescales(self, P, cfg: SimConfig, rt: Optional[Dict] = None, **kw):
        if rt is None:
            rt = self.default_rt(P)
        return self._timescales_impl(P, cfg, rt, **kw)
