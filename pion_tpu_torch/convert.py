"""Carry a run's state between the JAX reference package and this port.

The system has no weights; what the two packages must agree on is a run's
state: the configuration, the primitive field, the clock and the frozen
boundary strips.  The reference side is described without importing it: its
``SimConfig`` arrives as the plain dict that ``dataclasses.asdict`` gives
(enums as their string values — the same dict its snapshot headers carry),
the field as a numpy array.

These two functions are to grow to rate tables, radiation sources and
the nested-grid level stack.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .boundaries import BoundaryData
from .config import SimConfig

_PORT_FIELDS = {f.name for f in dataclasses.fields(SimConfig)}


def _plain(v):
    """Enums to their string values, tuples of tuples preserved."""
    if hasattr(v, "value") and isinstance(v.value, str):
        return v.value
    if isinstance(v, (tuple, list)):
        return tuple(_plain(x) for x in v)
    return v


def config_from_reference(cfg_fields: dict) -> SimConfig:
    """The port's ``SimConfig`` from the reference's config dict.  The
    reference's ``pallas`` switch becomes ``kernels`` ("off" stays "off",
    every other value means "auto"); a key the port does not know is
    rejected by name."""
    fields = dict(cfg_fields)
    kw = {}
    if "pallas" in fields:
        kw["kernels"] = "off" if fields.pop("pallas") == "off" else "auto"
    unknown = sorted(set(fields) - _PORT_FIELDS)
    if unknown:
        raise ValueError(f"unknown config keys: {', '.join(unknown)}")
    kw.update({k: _plain(v) for k, v in fields.items()})
    return SimConfig(**kw)


def config_to_reference(cfg: SimConfig) -> dict:
    """The reference's config dict from the port's ``SimConfig``
    (``kernels`` goes back to ``pallas``: "off" or "auto")."""
    d = {f.name: _plain(getattr(cfg, f.name))
         for f in dataclasses.fields(cfg)}
    d["pallas"] = d.pop("kernels")
    return d


def from_reference(cfg_fields: dict, P: np.ndarray, t: float = 0.0,
                   step: int = 0, last_dt: float = 0.0,
                   fixed: Optional[Dict[Tuple[int, int], np.ndarray]] = None,
                   device="cpu"):
    """A reference run's state as the port's
    ``(SimConfig, torch.Tensor, BoundaryData)``.

    ``P`` is the primitive state ``(nvar, *shape)``; it is cast to the
    config's dtype and put on ``device``.  ``fixed`` holds the frozen
    INFLOW/FIXED ghost strips keyed by ``(axis, side)``.  ``t``, ``step``
    and ``last_dt`` are the clock; they are validated here and handed to
    ``Simulation(cfg, P, t=..., step_count=..., last_dt=...)`` by the
    caller."""
    cfg = config_from_reference(cfg_fields)
    P = np.asarray(P)
    expect = (cfg.nvar,) + cfg.shape
    if P.shape != expect:
        raise ValueError(f"state shape {P.shape} != {expect}")
    if not (np.isfinite(t) and step >= 0 and last_dt >= 0.0):
        raise ValueError(f"bad clock: t={t}, step={step}, last_dt={last_dt}")
    # a copy in the config's dtype: the caller's array is never aliased
    Pt = torch.from_numpy(np.array(P, dtype=cfg.np_dtype)).to(device)
    strips = {}
    for (axis, side), arr in (fixed or {}).items():
        strips[(int(axis), int(side))] = np.asarray(arr, dtype=cfg.np_dtype)
    return cfg, Pt.contiguous(), BoundaryData(fixed=strips)


def to_reference(cfg: SimConfig, P: torch.Tensor,
                 bdata: Optional[BoundaryData] = None):
    """The way back: ``(config dict, numpy state, fixed strips)``."""
    fixed = {} if bdata is None else {k: np.asarray(v)
                                      for k, v in bdata.fixed.items()}
    return config_to_reference(cfg), P.detach().cpu().numpy(), fixed
