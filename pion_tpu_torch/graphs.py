"""Several steps in one dispatch: a chunk of a run as one CUDA graph.

The counterpart of the JAX package's ``lax.scan`` chunks
(``pion_tpu/stepper.py:218-258`` ``multi_step``, ``pion_tpu/ng.py:843-873``
``_multi_step_fn``).  The body of K steps is recorded once with
``torch.cuda.graph``; each chunk then costs one copy into the graph's input
buffers, one replay, and one copy of each output (a clone, so that what the
caller keeps never shares memory with the next replay).

A body that is captured never waits for the card: no read-back, no
``nonzero``, no copy from pageable host memory, no host branch on a device
value; a capture that meets one raises.  What the body makes lazily (the
kernel libraries, tables kept per dtype and device, a static wind's
free-wind state) is made before the capture by a warm-up run of the whole
body on clones of the inputs, on a side stream, whose results are dropped:
the run's state does not move.  Memory the body allocates belongs to the
graph's private pool, kept as long as the graph.

Each kernel wrapper counts its launches in its ``launches`` attribute.  The
wrappers are called while the graph is recorded, when nothing is launched:
what they add then is taken back, kept as the graph's launches a replay, and
added at every replay.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, List

import torch


def _counters():
    """(wrapper, attribute) of every launch counter of the kernel wrappers."""
    from .microphysics import fused_mpv3 as fm
    from .ops import fused_sweep as fs
    from .raytracing import fused_trace as ft

    return ((fs.sweep_axis, "launches"), (fs.final_axis, "launches"),
            (fm.ydot, "launches"), (fm.update, "launches"),
            (fm.update, "launches_seeded"), (ft.octant_trace, "launches"))


def _read_counts() -> List[int]:
    return [getattr(f, a) for f, a in _counters()]


def _add_counts(delta, base=None):
    for (f, a), d, b in zip(_counters(), delta,
                            base if base is not None else _read_counts()):
        setattr(f, a, b + d)


def clock(device, t: float, last_dt: float, t_target: float):
    """``(t, last_dt, t_stop, t_target)`` of a chunk as float64 0-d tensors
    on ``device`` (fill kernels, no copy from the host).  ``t_stop`` is the
    run loop's end test, ``t_target * (1 - 1e-12)``, formed on the host as
    the loop forms it."""
    return tuple(torch.full((), float(v), dtype=torch.float64, device=device)
                 for v in (t, last_dt, t_target * (1.0 - 1.0e-12), t_target))


def _flatten(tree, out: list) -> list:
    """The tensors of a nesting of tuples, lists and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _flatten(v, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif tree is not None:
        raise TypeError(f"a chunk's inputs and outputs are tensors, not "
                        f"{type(tree).__name__}")
    return out


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in order, from ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(v, leaves) for v in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return tree


def layout(tree):
    """What a graph is specialised on besides K: the nesting, and the
    shape and dtype of each tensor."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return tuple(layout(v) for v in tree)
    if isinstance(tree, dict):
        return tuple((k, layout(tree[k])) for k in sorted(tree))
    return tree


class ChunkGraph:
    """``body(*args)`` recorded once as a CUDA graph and replayed.

    ``args`` is a tuple of tensors and nestings of them (tuples, dicts,
    None), all on one CUDA device; ``body`` returns the same kind of
    nesting.  Calling the graph with arguments of the same layout copies
    them into its input buffers, replays it and returns clones of its
    outputs.  ``capture_s``: seconds of the capture (recording and
    instantiation); ``pool_bytes``: device memory reserved by it, the
    graph's pool; ``per_replay``: the launch counts a replay adds, by
    wrapper."""

    def __init__(self, body: Callable, args: tuple, name: str = "chunk"):
        leaves = _flatten(args, [])
        if not leaves or not all(x.is_cuda for x in leaves):
            raise ValueError("a CUDA graph is recorded from CUDA tensors")
        dev = leaves[0].device
        self.name = name
        # the input buffers, outside the graph's pool
        self._static = [x.clone() for x in leaves]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                body(*_rebuild(args, iter([x.clone() for x in leaves])))
            stream.wait_stream(side)
            torch.cuda.synchronize(dev)
            before = _read_counts()
            # (the capture empties the allocator's cache first: so does this,
            # so that what it reserves is the pool alone)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            # no collection of reference cycles while recording: one that
            # frees another graph (or tensors another stream uses) would
            # call into CUDA in the middle of the capture and void it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    out = body(*_rebuild(args, iter(self._static)))
            except Exception as err:
                _add_counts([0] * len(before), before)
                raise RuntimeError(
                    f"{name}: the capture as a CUDA graph failed ({err}); "
                    f"something in the body waits for the card") from err
            finally:
                if collecting:
                    gc.enable()
            self.capture_s = time.perf_counter() - t0
            after = _read_counts()
            _add_counts([0] * len(before), before)
            self.per_replay = [a - b for a, b in zip(after, before)]
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self._out = out
        self._out_leaves = _flatten(out, [])

    def __call__(self, args: tuple):
        leaves = _flatten(args, [])
        if len(leaves) != len(self._static):
            raise ValueError(f"{self.name}: {len(leaves)} input tensors, "
                             f"the graph was recorded with "
                             f"{len(self._static)}")
        for s, x in zip(self._static, leaves):
            s.copy_(x)
        self.graph.replay()
        _add_counts(self.per_replay)
        return _rebuild(self._out, iter([o.clone() for o in self._out_leaves]))
