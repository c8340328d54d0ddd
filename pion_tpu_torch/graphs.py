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

Each kernel wrapper counts its launches in its ``launches`` attribute
(listed by :func:`.tracing.launch_counters`).  The
wrappers are called while the graph is recorded, when nothing is launched:
what they add then is taken back, kept as the graph's launches a replay, and
added at every replay.

A sharded state (:class:`.parallel.mesh.Sharded`) is an input and an output
like a tuple of its blocks.  A mesh whose shards all lie on one card (one
card standing for every shard) is recorded as one graph; a mesh over
several devices or processes runs its chunk eagerly (:func:`on_one_card`),
with one read-back a chunk as on the CPU: a capture that spans several cards
is not recorded, nor one whose collectives cross processes (ROADMAP A20.5:
a graph a process with NCCL inside it is open).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, List

import torch

from . import tracing


def _read_counts() -> List[int]:
    return [getattr(f, a) for f, a in tracing.launch_counters()]


def _add_counts(delta, base=None):
    for (f, a), d, b in zip(tracing.launch_counters(), delta,
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
    """The tensors of a nesting of tuples, lists, dicts and sharded
    tensors (their blocks), in order."""
    from .parallel.mesh import Sharded

    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, Sharded):
        out.extend(b for b in tree.blocks if b is not None)
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
    """``tree`` with its tensors replaced, in order, from ``leaves`` (a
    sharded tensor keeps its mesh and shape)."""
    from .parallel.mesh import Sharded

    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, Sharded):
        return Sharded([None if b is None else next(leaves)
                        for b in tree.blocks], tree.mesh, tree.shape)
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(v, leaves) for v in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return tree


def layout(tree):
    """What a graph is specialised on besides K: the nesting, and the
    shape and dtype of each tensor (of a sharded tensor: its mesh's
    factors and each block's)."""
    from .parallel.mesh import Sharded

    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, Sharded):
        return ("sharded", tree.mesh.factors,
                tuple(None if b is None else layout(b) for b in tree.blocks))
    if isinstance(tree, (tuple, list)):
        return tuple(layout(v) for v in tree)
    if isinstance(tree, dict):
        return tuple((k, layout(tree[k])) for k in sorted(tree))
    return tree


def _distributed(tree) -> bool:
    """Whether ``tree`` holds a sharded tensor on a mesh of several
    processes."""
    from .parallel.mesh import Sharded

    if isinstance(tree, Sharded):
        return tree.mesh.distributed
    if isinstance(tree, (tuple, list)):
        return any(_distributed(v) for v in tree)
    if isinstance(tree, dict):
        return any(_distributed(v) for v in tree.values())
    return False


def key(K: int, sp) -> tuple:
    """What a run's cache of chunk graphs is keyed on: the chunk's K, the
    layout of the sources' inputs (:func:`layout`) and the tracing mode
    (:func:`.tracing.mode`), so that a graph recorded with tracing off is
    never replayed with the counters on, nor the reverse."""
    return (K, layout(sp), tracing.mode())


def on_one_card(tree) -> bool:
    """Whether every tensor of ``tree`` lies on one CUDA device, and none
    is sharded over several processes: what a chunk must hold to be
    recorded as one graph."""
    leaves = _flatten(tree, [])
    return (bool(leaves) and not _distributed(tree)
            and all(x.is_cuda and x.device == leaves[0].device
                    for x in leaves))


class ChunkGraph:
    """``body(*args)`` recorded once as a CUDA graph and replayed.

    ``args`` is a tuple of tensors and nestings of them (tuples, dicts,
    sharded tensors, None), all on one CUDA device; ``body`` returns the
    same kind of nesting.  Calling the graph with arguments of the same
    layout copies them into its input buffers, replays it and returns
    clones of its outputs.  ``capture_s``: seconds of the capture (recording and
    instantiation); ``pool_bytes``: device memory reserved by it, the
    graph's pool; ``per_replay``: the launch counts a replay adds, by
    wrapper.  Each call is the span ``run.replay``; the counters
    ``graph.captures`` and ``graph.replays`` count the captures and calls
    under the graph's ``name``."""

    def __init__(self, body: Callable, args: tuple, name: str = "chunk"):
        if not on_one_card(args):
            raise ValueError("a CUDA graph is recorded from CUDA tensors on "
                             "one device")
        leaves = _flatten(args, [])
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
        tracing.count("graph.captures", key=name)

    @tracing.spanned("run.replay")
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
        tracing.count("graph.replays", key=self.name)
        return _rebuild(self._out, iter([o.clone() for o in self._out_leaves]))
