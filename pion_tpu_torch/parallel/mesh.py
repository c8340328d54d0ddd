"""The device mesh and the sharded state (the MPI domain decomposition).

Counterpart of ``pion_tpu/parallel/mesh.py``.  The reference decomposes each
level into per-rank bricks (reference: source/decomposition/
MCMD_control.cpp:62-230); the JAX package shards one global array over a
``jax.sharding.Mesh`` and lets XLA infer the exchanges.  Torch has no such
compiler, so here a sharded state is explicit: a :class:`Sharded` holds one
contiguous block of the grid a shard, each a tensor on its shard's device,
and :mod:`.halo` moves the ghost strips between them.

Mesh axes are named after the array axes they shard: ('z','y','x') for 3D.
Like the reference, the slower axes take more shards first
(:func:`decompose`).  A mesh's devices come from the caller (one device may
stand for every shard: ``make_mesh(cfg, devices=[dev] * 8)``, how one card or
the CPU holds a 2x2x2 mesh, as the JAX tests hold it on eight virtual CPU
devices) or from the visible cards; never silently from the CPU.

Across blocks, :func:`region` assembles any box of the global grid from
the blocks that overlap it and :func:`write_regions` writes boxes back into
them: the nested-grid hierarchy's prolongation, restriction and BC89 planes
cross the shards through them, wherever a child block's window falls among
the parent's blocks.

Not ported: the JAX package's placement through ``mesh_utils`` (TPU
topology, which a card has none of) and ``maybe_distributed_init``: a mesh
lives in one process (multi-host is ROADMAP A20.5).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("z", "y", "x")


def decompose(n_devices: int, ndim: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Split n_devices into per-axis factors, most-divided on the slowest
    axis (reference: MCMD_control.cpp:62-230 'nx' search): the prime factors
    of ``n_devices``, largest first, each to the axis with the most cells a
    shard."""
    factors = [1] * ndim
    primes = []
    m = n_devices
    p = 2
    while m > 1:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    for prime in sorted(primes, reverse=True):
        ax = int(np.argmax([shape[i] / factors[i] for i in range(ndim)]))
        factors[ax] *= prime
    return tuple(factors)


def _split_dcn(factors, nproc):
    """Factor the per-axis shard counts into (hosts, per-host) so the
    slowest axes cross hosts: the exchange is nearest-neighbour on the mesh,
    so only the outermost slabs cross between hosts.  Kept for the
    multi-host step (ROADMAP A20.5); None when ``nproc`` does not divide
    the mesh that way."""
    dcn = [1] * len(factors)
    ici = list(factors)
    rem = nproc
    for ax in range(len(factors)):
        g = math.gcd(ici[ax], rem)
        dcn[ax] = g
        ici[ax] //= g
        rem //= g
        if rem == 1:
            break
    return (dcn, ici) if rem == 1 else None


class Mesh:
    """Devices laid out by the mesh factors (``devices``: a numpy object
    array of ``torch.device``), with one axis name a grid axis.  Shards are
    numbered in the array's C order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.coords: List[Tuple[int, ...]] = list(np.ndindex(devices.shape))

    @property
    def factors(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def shape(self) -> dict:
        """Shards along each named axis (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.factors))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, b: int) -> torch.device:
        return self.devices[self.coords[b]]

    def index(self, coord: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coord), self.factors))

    def neighbour(self, b: int, axis: int, step: int) -> int:
        """The shard ``step`` places along ``axis`` from shard ``b``, round
        the ring."""
        c = list(self.coords[b])
        c[axis] = (c[axis] + step) % self.factors[axis]
        return self.index(c)

    def block_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """Cells a shard along each axis of a grid of ``shape``."""
        if len(shape) != len(self.factors) or any(
                n % f for n, f in zip(shape, self.factors)):
            raise ValueError(f"a grid of {tuple(shape)} cells does not split "
                             f"evenly over a mesh of {self.factors}")
        return tuple(n // f for n, f in zip(shape, self.factors))

    def ranges(self, shape: Sequence[int]) -> List[Tuple[Tuple[int, int], ...]]:
        """Each shard's global index range ``(lo, hi)`` along every axis."""
        blk = self.block_shape(shape)
        return [tuple((c * n, (c + 1) * n) for c, n in zip(coord, blk))
                for coord in self.coords]

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> List[torch.device]:
    """The devices a mesh takes when its caller names none: every visible
    CUDA device (none without a card).  The one place that lists them, so
    that a test can stand eight CPU devices in for eight cards."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg, n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The spatial mesh of ``cfg``'s grid over ``devices`` (a list, in which
    one device may stand several times), else over the first ``n_devices``
    (all, by default) of :func:`visible_devices`; without a card and
    without ``devices`` it raises.  The factors are :func:`decompose`'s."""
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError(
                "no CUDA device for the mesh; give its devices "
                "(make_mesh(cfg, devices=['cpu'] * 8) for CPU shards)")
        if n_devices is not None:
            if not 1 <= n_devices <= len(devices):
                raise ValueError(f"{n_devices} devices asked, "
                                 f"{len(devices)} visible")
            devices = devices[:n_devices]
    devices = [_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    factors = decompose(len(devices), cfg.ndim, cfg.shape)
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return Mesh(arr.reshape(factors), AXIS_NAMES[-cfg.ndim:])


def mesh_requested(cfg) -> bool:
    """Whether ``cfg.mesh`` shards a run over :func:`visible_devices` (the
    JAX package's gate): never with one visible device; "on" with several;
    "auto" with several cards (the JAX package's accelerator backends)."""
    devs = visible_devices()
    if len(devs) <= 1:
        return False
    return cfg.mesh == "on" or (cfg.mesh == "auto"
                                and all(d.type == "cuda" for d in devs))


class Sharded:
    """A tensor split over a mesh: its last ``len(mesh.factors)`` axes are
    the grid's, cut into equal contiguous blocks, one a shard (in the mesh's
    order), each on its shard's device; the leading axes (the variables of a
    state) stay whole.  ``shape`` is the whole tensor's."""

    def __init__(self, blocks: Sequence[torch.Tensor], mesh: Mesh,
                 shape: Sequence[int]):
        if len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks for {mesh.size} shards")
        self.blocks = list(blocks)
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return self.shape[len(self.shape) - len(self.mesh.factors):]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device: where reductions over the shards land."""
        return self.blocks[0].device

    @property
    def is_cuda(self) -> bool:
        return self.blocks[0].is_cuda

    def ranges(self):
        """Each shard's global index range along every grid axis."""
        return self.mesh.ranges(self.grid_shape)

    def map(self, fn) -> "Sharded":
        """``fn`` of every block (one that keeps the block's shape)."""
        return Sharded([fn(b) for b in self.blocks], self.mesh, self.shape)

    def gather(self, device=None) -> torch.Tensor:
        return gather(self, device)

    def all_finite(self) -> bool:
        return all(bool(torch.isfinite(b).all()) for b in self.blocks)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"mesh={self.mesh})")


def shard_state(P, mesh: Mesh, cfg=None) -> Sharded:
    """``P`` (``(nvar, *shape)``, or any tensor whose last axes are the
    grid's) split over ``mesh``: a copy of each block on its shard's device,
    in ``P``'s dtype.  A :class:`Sharded` on another mesh is gathered
    first; on this mesh it is returned as it is."""
    if isinstance(P, Sharded):
        if P.mesh is mesh:
            return P
        P = P.gather()
    P = torch.as_tensor(P)
    nd = len(mesh.factors)
    lead = (slice(None),) * (P.ndim - nd)
    blocks = []
    for b, rng in enumerate(mesh.ranges(P.shape[P.ndim - nd:])):
        part = P[lead + tuple(slice(lo, hi) for lo, hi in rng)]
        blk = torch.empty(part.shape, dtype=P.dtype, device=mesh.device(b))
        blk.copy_(part)
        blocks.append(blk)
    return Sharded(blocks, mesh, P.shape)


def gather(S, device=None) -> torch.Tensor:
    """The whole tensor of a :class:`Sharded` (a new tensor on ``device``,
    the first shard's by default); anything else is returned as it is."""
    if not isinstance(S, Sharded):
        return S
    dev = S.device if device is None else _device(device)
    nd = len(S.mesh.factors)
    lead = len(S.shape) - nd
    parts = np.empty(len(S.blocks), dtype=object)
    for i, b in enumerate(S.blocks):
        parts[i] = b.to(dev)
    parts = parts.reshape(S.mesh.factors)
    for a in reversed(range(nd)):
        joined = np.empty(parts.shape[:-1], dtype=object)
        for idx in np.ndindex(parts.shape[:-1]):
            joined[idx] = torch.cat(list(parts[idx]), dim=lead + a)
        parts = joined
    return parts[()]


def _box_parts(shape, box):
    """``box`` (a ``(lo, hi)`` a grid axis, which may reach past the grid
    but overlaps it) as the part inside the grid and the number of edge
    cells it repeats past each end."""
    inside, clamp = [], []
    for n, (lo, hi) in zip(shape, box):
        a, b = max(lo, 0), min(hi, n)
        if a >= b:
            raise ValueError(f"box {tuple(box)} lies outside a grid of "
                             f"{tuple(shape)}")
        inside.append((a, b))
        clamp.append((a - lo, hi - b))
    return inside, clamp


def region(S: Sharded, box, device=None) -> torch.Tensor:
    """The box of the global grid (``box``: a ``(lo, hi)`` a grid axis, in
    global cell indices; past the grid's edges the edge cells repeat) as a
    new tensor on ``device`` (the first shard's by default), its leading
    axes whole, assembled from the blocks that overlap it, each overlap
    copied once."""
    lead = len(S.shape) - len(S.mesh.factors)
    inside, clamp = _box_parts(S.grid_shape, box)
    dev = S.device if device is None else _device(device)
    out = torch.empty(tuple(S.shape[:lead]) + tuple(
        b - a for a, b in inside), dtype=S.dtype, device=dev)
    for blk, rng in zip(S.blocks, S.ranges()):
        cut = [(max(a, lo), min(b, hi)) for (a, b), (lo, hi)
               in zip(inside, rng)]
        if any(c0 >= c1 for c0, c1 in cut):
            continue
        src = blk[(slice(None),) * lead + tuple(
            slice(c0 - lo, c1 - lo) for (c0, c1), (lo, _) in zip(cut, rng))]
        out[(slice(None),) * lead + tuple(
            slice(c0 - a, c1 - a) for (c0, c1), (a, _) in zip(cut, inside))
            ] = src.to(dev, non_blocking=True)
    for ax, (c_lo, c_hi) in enumerate(clamp):
        if not (c_lo or c_hi):
            continue
        a = lead + ax
        n = out.shape[a]
        parts = [out.narrow(a, 0, 1)] * c_lo + [out] + \
            [out.narrow(a, n - 1, 1)] * c_hi
        out = torch.cat(parts, dim=a)
    return out


def write_regions(S: Sharded, writes) -> Sharded:
    """``S`` with each ``(box, value)`` of ``writes`` written in (boxes
    inside the grid, in global cell indices; ``value`` a tensor of the
    box's shape on any device): a new :class:`Sharded` whose blocks that no
    box overlaps are ``S``'s own, and whose others are copies, written."""
    nd = len(S.mesh.factors)
    lead = len(S.shape) - nd
    blocks = list(S.blocks)
    copied = set()
    for box, value in writes:
        for b, rng in enumerate(S.ranges()):
            cut = [(max(a, lo), min(c, hi)) for (a, c), (lo, hi)
                   in zip(box, rng)]
            if any(c0 >= c1 for c0, c1 in cut):
                continue
            if b not in copied:
                blocks[b] = blocks[b].clone()
                copied.add(b)
            part = value[(slice(None),) * lead + tuple(
                slice(c0 - a, c1 - a) for (c0, c1), (a, _) in zip(cut, box))]
            blocks[b][(slice(None),) * lead + tuple(
                slice(c0 - lo, c1 - lo) for (c0, c1), (lo, _) in zip(cut, rng))
                ] = part.to(blocks[b].device, non_blocking=True)
    return Sharded(blocks, S.mesh, S.shape)
