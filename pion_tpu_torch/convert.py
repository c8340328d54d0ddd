"""Carry a run's state between the JAX reference package and this port.

The system has no weights; what the two packages must agree on is a run's
state: the configuration, the primitive field, the clock and the frozen
boundary strips.  The reference side is described without importing it: its
``SimConfig`` arrives as the plain dict that ``dataclasses.asdict`` gives
(enums as their string values — the same dict its snapshot headers carry),
the field as a numpy array.

The chemistry and radiation set-up crosses the same way: the reference's
``MPv3Config`` and each ``Source`` as their ``dataclasses.asdict`` dicts (a
source's evolution table as numpy arrays), from which
:func:`physics_from_reference` builds the port's ``Physics``.  The port
rebuilds its own rate tables; :func:`check_rate_tables` holds them against
arrays taken from the reference module.  Stellar-wind sources cross as their
``dataclasses.asdict`` dicts too (:func:`wind_source_from_reference`), and a
nested-grid run as its level-0 config and one numpy state per level
(:func:`hierarchy_from_reference` / :func:`hierarchy_to_reference`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .boundaries import BoundaryData
from .config import SimConfig
from .microphysics.mpv3 import MPv3, MPv3Config
from .physics import Physics
from .raytracing.tracer import Source, StarEvolution
from .winds import WindEvolution, WindSource

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


def mpv3_config_from_reference(mpc_fields: dict) -> MPv3Config:
    """The port's ``MPv3Config`` from the reference's, given as its
    ``dataclasses.asdict`` dict; a key the port does not know is rejected by
    name."""
    known = {f.name for f in dataclasses.fields(MPv3Config)}
    unknown = sorted(set(mpc_fields) - known)
    if unknown:
        raise ValueError(f"unknown MPv3Config keys: {', '.join(unknown)}")
    return MPv3Config(**mpc_fields)


def source_from_reference(src_fields: dict) -> Source:
    """The port's ``Source`` from the reference's ``dataclasses.asdict``
    dict.  ``evolution`` is None or a dict of the four table columns."""
    fields = dict(src_fields)
    known = {f.name for f in dataclasses.fields(Source)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown Source keys: {', '.join(unknown)}")
    evo = fields.pop("evolution", None)
    if evo is not None:
        evo = StarEvolution(**{k: np.array(evo[k], dtype=np.float64)
                               for k in ("time", "log_L", "log_T", "log_R")})
    fields["position"] = tuple(float(v) for v in fields.get("position", ()))
    return Source(evolution=evo, **fields)


def wind_source_from_reference(fields: dict) -> WindSource:
    """The port's ``WindSource`` from the reference's ``dataclasses.asdict``
    dict.  ``evolution`` is None or a dict of the table's columns (``v_rot``
    and ``vcrit`` may be None)."""
    fields = dict(fields)
    known = {f.name for f in dataclasses.fields(WindSource)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown WindSource keys: {', '.join(unknown)}")
    evo = fields.pop("evolution", None)
    if evo is not None:
        cols = {f.name for f in dataclasses.fields(WindEvolution)}
        unknown = sorted(set(evo) - cols)
        if unknown:
            raise ValueError(
                f"unknown WindEvolution keys: {', '.join(unknown)}")
        evo = WindEvolution(**{
            k: None if v is None else np.array(v, dtype=np.float64)
            for k, v in evo.items()})
    for k in ("position", "tracers", "periastron"):
        if k in fields:
            fields[k] = tuple(float(v) for v in fields[k])
    return WindSource(evolution=evo, **fields)


def physics_from_reference(mpc_fields: Optional[dict],
                           sources: Sequence[dict] = (),
                           dt_limit=2,
                           wind_sources: Sequence[dict] = ()) -> Physics:
    """The port's ``Physics`` (MPv3 chemistry, radiation sources and
    stellar-wind sources) from the reference's set-up, so that both packages
    compute the same thing."""
    mp = None if mpc_fields is None else MPv3(
        mpv3_config_from_reference(mpc_fields))
    return Physics(
        mp=mp, sources=[source_from_reference(s) for s in sources],
        dt_limit=dt_limit,
        wind_sources=[wind_source_from_reference(w) for w in wind_sources])


def hierarchy_from_reference(cfg_fields: dict, states: Sequence[np.ndarray],
                             t: float = 0.0, step: int = 0,
                             last_dt: float = 0.0, physics=None,
                             device=None):
    """A reference nested-grid run as the port's ``NGHierarchy``: the
    level-0 config dict (``nlevels`` says how many levels unless the states
    do), one primitive state per level as numpy, and the clock.  ``physics``
    is the port's own (:func:`physics_from_reference`).  ``device`` goes to
    ``NGHierarchy`` as it is: ``None`` is the card, or an error where there
    is none; ``"cpu"`` on request."""
    from .ng import NGHierarchy

    cfg = config_from_reference(cfg_fields)
    if not (np.isfinite(t) and step >= 0 and last_dt >= 0.0):
        raise ValueError(f"bad clock: t={t}, step={step}, last_dt={last_dt}")
    hier = NGHierarchy(cfg, len(states), physics=physics, device=device)
    hier.t, hier.step_count, hier.last_dt = float(t), int(step), float(last_dt)
    # copies in the config's dtype: the caller's arrays are never aliased
    hier.set_states([np.array(s, dtype=cfg.np_dtype) for s in states])
    return hier


def hierarchy_to_reference(hier):
    """The way back: ``(config dict, [numpy state per level], t, step,
    last_dt)``; the config carries the level count and the snapped centre,
    as a snapshot header does."""
    return (config_to_reference(hier._header_cfg()),
            [p.detach().cpu().numpy() for p in hier.P], hier.t,
            hier.step_count, hier.last_dt)


# tables of the reference that are layouts for the TPU's one-hot matrix
# lookups, not rates: the port reads rows instead and has no such table
TPU_LAYOUT_TABLES = ("t1_aug",)


def check_rate_tables(mp: MPv3, ref_tab: Dict[str, np.ndarray],
                      rtol: float = 1.0e-13) -> int:
    """Hold the port's rate tables against arrays taken from the reference
    module's ``tab`` dict (as numpy).  Every table of the reference but
    ``TPU_LAYOUT_TABLES`` must exist in the port with the same shape and
    agree to ``rtol``; the port's
    own extra layouts (``t1_rows``, ``tau_rows``) are checked against the
    stacks they transpose.  Returns the number of tables compared; raises
    ``ValueError`` on the first that disagrees."""
    n = 0
    for name, ref in ref_tab.items():
        if name in TPU_LAYOUT_TABLES:
            continue
        ref = np.asarray(ref, dtype=np.float64)
        if name not in mp.tab:
            raise ValueError(f"rate table {name!r} is missing in the port")
        mine = mp.tab[name]
        if mine.shape != ref.shape:
            raise ValueError(f"rate table {name!r}: shape {mine.shape} != "
                             f"{ref.shape}")
        if not np.allclose(mine, ref, rtol=rtol, atol=0.0):
            worst = float(np.max(np.abs(mine - ref)
                                 / np.maximum(np.abs(ref), 1e-300)))
            raise ValueError(f"rate table {name!r} disagrees: max relative "
                             f"difference {worst:.3e} > {rtol:.1e}")
        n += 1
    for rows, stack in (("t1_rows", "t1_stack"), ("tau_rows", "tau_stack")):
        if rows in mp.tab and not np.array_equal(mp.tab[rows],
                                                 mp.tab[stack].T):
            raise ValueError(f"{rows} is not the transpose of {stack}")
    return n
