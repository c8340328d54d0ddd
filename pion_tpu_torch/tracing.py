"""Spans and counters of the port: one registry and one switch.

Tracing is off by default.  ``enable("host")`` or ``enable("device")``
turns it on (and empties the registry's spans and the ladder counters),
``disable()`` turns it off again; ``summary()`` returns what the registry
holds as a plain dict.

A span marks a piece of work by name (``with span("fill"): ...``).  Off,
``span`` returns one shared null context after one check and allocates
nothing.  On, it enters ``torch.profiler.record_function(name)``, which
puts the span on the profiler's host timeline and, through the profiler's
GPU user annotations, over the kernels it launched on the device timeline,
so that spans and device trace share one clock; and it adds the span's host
seconds and calls to the registry (a :class:`.utils.Timers`).  A span
nested in one of its own name counts once, as the outer one.

The two modes differ in how a chunk of steps is dispatched.  A CUDA graph
replay runs no host code, so the spans inside a chunk's body fire once, at
its capture, and never at a replay:

- ``"host"``: chunks replay their CUDA graphs, as with tracing off; the
  run loop's spans (``run.*``) and the counters are what it shows.
- ``"device"``: ``Simulation.run`` and ``NGHierarchy.run`` run each chunk's
  body eagerly (the body the graph records, which reads nothing back), so
  every span of the step's body fires and lies over its kernels on the
  device timeline.

The graph cache key (:func:`.graphs.key`) holds the mode: a graph recorded
with tracing off is never replayed with counters on, nor the reverse.

Counters are plain ints (the kernel wrappers' ``launches`` attributes, the
interface planes B1 hands back, ``sweep_axis.planes``, and the plain slab
sweeps that recompute such planes, ``_slab_faces.sweeps``, listed by
:func:`launch_counters`; ``graph.captures`` and ``graph.replays``
by graph; ``comm.bytes_sent`` and ``comm.messages``), counted whether
tracing is on or off, and the chemistry ladder's device counters
``chem.ladder_tiles`` and ``chem.newton_iters``: with tracing on, one int32
pair a device (:func:`ladder_stats`), made before any capture (a chunk's
warm-up run makes it), which the B3 kernels add to, replays included; it is
read only by :func:`summary`.

The span names, by where they are entered:

- run loop (``sim.py``, ``ng.py``, ``graphs.py``): ``run.chunk`` (one
  chunked call of ``run``), ``run.sources`` (the sources' parameters),
  ``run.replay`` (a graph's input copies, replay and output clones),
  ``run.readback`` (the chunk's one read-back);
- step body (``stepper.py``, ``ng.py``, ``physics.py``): ``step.dt``,
  ``step.select``, ``fill``, ``glue.prolong``, ``glue.restrict``,
  ``glue.bc89``, ``sweep``, ``update``, ``chem``, ``trace``, ``winds``.

A graph's capture is timed by its own ``ChunkGraph.capture_s``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from .utils import Timers

MODES = ("host", "device")
RUN_SPANS = ("run.chunk", "run.sources", "run.replay", "run.readback")
STEP_SPANS = ("step.dt", "step.select", "fill", "glue.prolong",
              "glue.restrict", "glue.bc89", "sweep", "update", "chem",
              "trace", "winds")

_mode: Optional[str] = None
_null = contextlib.nullcontext()
# host seconds and calls by span, and the depth of each open span's name
_timers = Timers()
_depth: Dict[str, int] = {}
# plain counters: name -> int, or name -> {graph name: int}
_counts: Dict[str, object] = {"comm.bytes_sent": 0, "comm.messages": 0}
# chemistry ladder counters: device -> int32 (tiles, Newton iterations)
_ladder: Dict[torch.device, torch.Tensor] = {}


def enable(mode: str) -> None:
    """Turn tracing on in ``mode`` ("host" or "device"), with the spans'
    times and calls and the ladder counters set to zero."""
    global _mode, _timers
    if mode not in MODES:
        raise ValueError(f"tracing mode is one of {MODES}, not {mode!r}")
    if any(_depth.values()):
        raise RuntimeError("tracing.enable inside an open span")
    _timers = Timers()
    for pair in _ladder.values():
        pair.zero_()
    _mode = mode


def disable() -> None:
    """Turn tracing off; the registry keeps what it holds."""
    global _mode
    _mode = None


def mode() -> Optional[str]:
    """The mode, or None when tracing is off."""
    return _mode


def eager() -> bool:
    """Whether chunks run their bodies eagerly (the "device" mode)."""
    return _mode == "device"


class _Span:
    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if not _depth.get(self.name):
            _timers.start(self.name)
        _depth[self.name] = _depth.get(self.name, 0) + 1
        return self

    def __exit__(self, *exc):
        _depth[self.name] -= 1
        if not _depth[self.name]:
            _timers.pause(self.name)
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking the work inside it as ``name``: the shared
    null context when tracing is off."""
    if _mode is None:
        return _null
    return _Span(name)


def is_span(name: str) -> bool:
    """Whether ``name`` is one of the port's span names."""
    return name in RUN_SPANS or name in STEP_SPANS


def spanned(name: str):
    """A decorator: the whole call of the function inside ``span(name)``."""
    def wrap(fn):
        def call(*args, **kw):
            if _mode is None:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        call.__name__, call.__qualname__ = fn.__name__, fn.__qualname__
        call.__doc__, call.__wrapped__ = fn.__doc__, fn
        return call
    return wrap


def count(name: str, n: int = 1, key: Optional[str] = None) -> None:
    """Add ``n`` to the plain counter ``name`` (under ``key``, a graph's
    name, for the counters kept by graph)."""
    if key is None:
        _counts[name] = _counts.get(name, 0) + n
    else:
        by = _counts.setdefault(name, {})
        by[key] = by.get(key, 0) + n


def launch_counters():
    """(function, attribute) of every counter kept on a function: the
    kernel wrappers' launches, B1's interface planes and the plain slab
    sweeps, in a fixed order."""
    from .microphysics import fused_mpv3 as fm
    from .ops import fused_sweep as fs
    from .ops import sweep as sw
    from .raytracing import fused_trace as ft
    from .raytracing import sharded_trace as st

    return ((fs.sweep_axis, "launches"), (fs.final_axis, "launches"),
            (fm.ydot, "launches"), (fm.update, "launches"),
            (fm.update, "launches_seeded"), (ft.octant_trace, "launches"),
            (st.sharded_octant_trace, "launches"),
            (fs.sweep_axis, "planes"), (sw._slab_faces, "sweeps"))


def ladder_stats(device) -> Optional[torch.Tensor]:
    """The chemistry ladder's counter pair on ``device`` (int32 tiles that
    ran the ladder, Newton iterations they took), or None with tracing
    off.  Made at its first call, which must not fall inside a capture: a
    chunk's warm-up run, before its capture, makes it."""
    if _mode is None:
        return None
    device = torch.device(device)
    pair = _ladder.get(device)
    if pair is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the ladder counters are made outside a "
                               "capture (by the chunk's warm-up run)")
        pair = _ladder[device] = torch.zeros(2, dtype=torch.int32,
                                             device=device)
    return pair


def summary() -> dict:
    """What the registry holds: ``spans`` (each span's ``calls`` and
    ``host_s``), ``counters`` (the wrappers' launches by
    ``module.wrapper[.attribute]``, the graph counters by graph, the comm
    counters, and the ladder counters summed over the devices, read back
    here, where there are any) and ``mode``."""
    spans = {name: {"calls": _timers.calls(name),
                     "host_s": _timers.read(name)}
             for name in sorted(_timers.report())}
    counters = {}
    for fn, attr in launch_counters():
        name = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"
        if attr != "launches":
            name += f".{attr}"
        counters[name] = getattr(fn, attr)
    for name, v in _counts.items():
        counters[name] = dict(v) if isinstance(v, dict) else v
    if _ladder:
        tiles = newton = 0
        for pair in _ladder.values():
            t, n = pair.tolist()
            tiles, newton = tiles + t, newton + n
        counters["chem.ladder_tiles"] = tiles
        counters["chem.newton_iters"] = newton
    return {"mode": _mode, "spans": spans, "counters": counters}
