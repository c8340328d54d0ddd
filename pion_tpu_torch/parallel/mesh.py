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

A mesh may span several processes, one a card (or several on the CPU),
under a ``torch.distributed`` group (:mod:`.comm`): each shard has an
owning rank, a process holds only its own blocks (a :class:`Sharded`
holds None for the others'), every process runs the same program on its
blocks, and what crosses a process (a strip, a box, a gathered state, a
reduction) goes through :mod:`.comm`.  The shards are placed as the JAX
package's ``create_hybrid_device_mesh`` places them (:func:`placement`:
the slowest axes across processes).  Not ported: the placement within a
process by TPU topology, which a card has none of.
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
    so only the outermost slabs cross between hosts (the JAX package's,
    ``pion_tpu/parallel/mesh.py:50-67``); None when ``nproc`` does not
    divide the mesh that way."""
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


def placement(factors: Sequence[int], counts: Sequence[int]):
    """Each shard's owning rank and its index among that rank's devices,
    as two int arrays of shape ``factors``, for ranks that bring
    ``counts[r]`` devices each: the JAX package's multi-host placement
    (``pion_tpu/parallel/mesh.py:93-98``).  Where :func:`_split_dcn` splits
    the factors into ``(dcn, ici)``, shard coordinate ``c`` belongs to rank
    ``ravel(c // ici)`` over the ``dcn`` grid and is its device
    ``ravel(c % ici)`` (``mesh_utils.create_hybrid_device_mesh``'s layout);
    else the devices are laid out rank-major in a plain reshape, as the
    JAX package's fallback does."""
    factors = tuple(int(f) for f in factors)
    n = int(np.prod(factors))
    if sum(counts) != n:
        raise ValueError(f"{sum(counts)} devices for a mesh of {factors}")
    nproc = len(counts)
    split = (_split_dcn(factors, nproc)
             if len(set(counts)) == 1 else None)
    if split is None:
        starts = np.cumsum([0] + list(counts))
        flat = np.arange(n)
        owner = np.searchsorted(starts, flat, side="right") - 1
        return (owner.reshape(factors),
                (flat - starts[owner]).reshape(factors))
    dcn, ici = split
    owner = np.empty(factors, dtype=np.int64)
    local = np.empty(factors, dtype=np.int64)
    for c in np.ndindex(*factors):
        owner[c] = np.ravel_multi_index(
            tuple(ci // ii for ci, ii in zip(c, ici)), dcn)
        local[c] = np.ravel_multi_index(
            tuple(ci % ii for ci, ii in zip(c, ici)), ici)
    return owner, local


class Mesh:
    """Devices laid out by the mesh factors (``devices``: a numpy object
    array of ``torch.device``, None at the shards of other processes), with
    one axis name a grid axis.  Shards are numbered in the array's C order.
    ``ranks``: each shard's owning rank (all 0 in one process); ``rank``:
    this process's; ``distributed``: the mesh spans a process group, and
    what crosses a process goes through :mod:`.comm`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, rank: int = 0,
                 distributed: bool = False):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.coords: List[Tuple[int, ...]] = list(np.ndindex(devices.shape))
        self.ranks = (np.zeros(devices.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64))
        self.rank = int(rank)
        self.distributed = bool(distributed)
        # this process's shards, in the mesh's order
        self.local: List[int] = [b for b, c in enumerate(self.coords)
                                 if self.ranks[c] == self.rank]
        if not self.local:
            raise ValueError(f"rank {self.rank} owns no shard of the mesh")

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

    @property
    def process_ranks(self) -> List[int]:
        """The ranks that own shards of the mesh."""
        return sorted({int(r) for r in self.ranks.flat})

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where its reductions
        over its shards land."""
        return self.device(self.local[0])

    def local_devices(self) -> List[torch.device]:
        """The devices of this process's shards, each once."""
        return list(dict.fromkeys(self.device(b) for b in self.local))

    def device(self, b: int) -> Optional[torch.device]:
        """Shard ``b``'s device (None where another process owns it)."""
        return self.devices[self.coords[b]]

    def owner(self, b: int) -> int:
        return int(self.ranks[self.coords[b]])

    def owns(self, b: int) -> bool:
        return self.owner(b) == self.rank

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

    def transfer(self, moves):
        """A phase of :class:`.comm.Move` s between the shards' processes
        (:func:`.comm.transfer`; in one process, every move a
        ``Tensor.to``)."""
        if self.distributed:
            from . import comm

            return comm.transfer(moves)
        return [m.send.to(m.device, non_blocking=True) for m in moves]

    def reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ("min", "max" or "sum") of this process's reduction ``x``
        over the mesh's processes (``x`` itself in one process)."""
        if self.distributed:
            from . import comm

            return comm.all_reduce(x, op)
        return x

    def reduce_ints(self, values: Sequence[int], op: str) -> List[int]:
        """:meth:`reduce` of a few host integers."""
        if self.distributed:
            from . import comm

            return comm.all_reduce_ints(values, op)
        return [int(v) for v in values]

    def barrier(self):
        """Wait for every process of the mesh (nothing in one process)."""
        if self.distributed:
            from . import comm

            comm.barrier()

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat if d is not None})
        procs = (f", ranks={self.process_ranks}, rank={self.rank}"
                 if self.distributed else "")
        return f"Mesh({self.shape}, devices={devs}{procs})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> List[torch.device]:
    """The devices a mesh takes when its caller names none: every visible
    CUDA device (none without a card); under a process group, every
    process's device (:func:`.comm.local_device`), rank-major.  The one
    place that lists them, so that a test can stand eight CPU devices in
    for eight cards."""
    from . import comm

    if comm.initialized():
        return [comm.local_device()] * comm.world_size()
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(cfg, n_devices: Optional[int] = None, devices=None) -> Mesh:
    """The spatial mesh of ``cfg``'s grid over ``devices`` (a list, in which
    one device may stand several times), else over the first ``n_devices``
    (all, by default) of :func:`visible_devices`; without a card and
    without ``devices`` it raises.  The factors are :func:`decompose`'s.

    Under a process group (:mod:`.comm`) ``devices`` is this process's list
    (by default its one device, :func:`.comm.local_device`), every rank
    must give as many, and the mesh has the world size times that many
    shards, placed as :func:`placement` says."""
    from . import comm

    multi = comm.initialized()
    if devices is None:
        devices = [comm.local_device()] if multi else visible_devices()
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
    names = AXIS_NAMES[-cfg.ndim:]
    if not multi:
        factors = decompose(len(devices), cfg.ndim, cfg.shape)
        arr = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            arr[i] = d
        return Mesh(arr.reshape(factors), names)
    world, me = comm.world_size(), comm.rank()
    most, least = comm.all_reduce_ints([len(devices), -len(devices)], "max")
    if most != -least:
        raise ValueError(f"rank {me} brings {len(devices)} devices to the "
                         f"mesh; every rank must bring as many (between "
                         f"{-least} and {most} here)")
    factors = decompose(world * len(devices), cfg.ndim, cfg.shape)
    owner, local = placement(factors, [len(devices)] * world)
    arr = np.empty(factors, dtype=object)
    for c in np.ndindex(*factors):
        arr[c] = devices[local[c]] if owner[c] == me else None
    return Mesh(arr, names, ranks=owner, rank=me, distributed=True)


def mesh_requested(cfg) -> bool:
    """Whether ``cfg.mesh`` shards a run over :func:`visible_devices` (the
    JAX package's gate; every process's devices under a group): never with
    one device; "on" with several; "auto" with several cards (the JAX
    package's accelerator backends)."""
    devs = visible_devices()
    if len(devs) <= 1:
        return False
    return cfg.mesh == "on" or (cfg.mesh == "auto"
                                and all(d.type == "cuda" for d in devs))


class Sharded:
    """A tensor split over a mesh: its last ``len(mesh.factors)`` axes are
    the grid's, cut into equal contiguous blocks, one a shard (in the mesh's
    order), each on its shard's device; the leading axes (the variables of a
    state) stay whole.  ``shape`` is the whole tensor's.  On a mesh of
    several processes ``blocks`` holds None at the shards of the others."""

    def __init__(self, blocks: Sequence[Optional[torch.Tensor]], mesh: Mesh,
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
    def block_shape(self) -> Tuple[int, ...]:
        """Every block's shape."""
        nd = len(self.mesh.factors)
        return (self.shape[:len(self.shape) - nd]
                + self.mesh.block_shape(self.grid_shape))

    @property
    def first(self) -> torch.Tensor:
        """This process's first block."""
        return self.blocks[self.mesh.local[0]]

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    @property
    def device(self) -> torch.device:
        """This process's first shard's device: where reductions over the
        shards land."""
        return self.first.device

    @property
    def is_cuda(self) -> bool:
        return self.first.is_cuda

    def local(self):
        """``(b, block)`` of this process's shards."""
        return [(b, self.blocks[b]) for b in self.mesh.local]

    def ranges(self):
        """Each shard's global index range along every grid axis."""
        return self.mesh.ranges(self.grid_shape)

    def map(self, fn) -> "Sharded":
        """``fn`` of every block of this process (one that keeps the
        block's shape)."""
        return Sharded([None if b is None else fn(b) for b in self.blocks],
                       self.mesh, self.shape)

    def gather(self, device=None, dst="all") -> Optional[torch.Tensor]:
        return gather(self, device, dst)

    def all_finite(self) -> bool:
        ok = int(all(bool(torch.isfinite(b).all()) for _, b in self.local()))
        return bool(self.mesh.reduce_ints([ok], "min")[0])

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"mesh={self.mesh})")


def shard_state(P, mesh: Mesh, cfg=None) -> Sharded:
    """``P`` (``(nvar, *shape)``, or any tensor whose last axes are the
    grid's) split over ``mesh``: a copy of each block of this process on
    its shard's device, in ``P``'s dtype (on a mesh of several processes
    every rank holds the whole ``P`` and keeps its blocks).  A
    :class:`Sharded` on another mesh is gathered first; on this mesh it is
    returned as it is."""
    if isinstance(P, Sharded):
        if P.mesh is mesh:
            return P
        P = P.gather()
    P = torch.as_tensor(P)
    nd = len(mesh.factors)
    lead = (slice(None),) * (P.ndim - nd)
    blocks = [None] * mesh.size
    rngs = mesh.ranges(P.shape[P.ndim - nd:])
    for b in mesh.local:
        part = P[lead + tuple(slice(lo, hi) for lo, hi in rngs[b])]
        blk = torch.empty(part.shape, dtype=P.dtype, device=mesh.device(b))
        blk.copy_(part)
        blocks[b] = blk
    return Sharded(blocks, mesh, P.shape)


def _receivers(mesh: Mesh, dst):
    """The ranks that receive a gathered tensor or a box: every rank of
    the mesh for "all", else those listed (or the one given)."""
    if dst == "all":
        return mesh.process_ranks
    if isinstance(dst, int):
        return [dst]
    return sorted({int(r) for r in dst})


def gather(S, device=None, dst="all") -> Optional[torch.Tensor]:
    """The whole tensor of a :class:`Sharded` (a new tensor on ``device``,
    this process's first shard's by default); anything else is returned as
    it is.  On a mesh of several processes it arrives on the ranks ``dst``
    ("all", a rank or a list of ranks) and is None on the others."""
    if not isinstance(S, Sharded):
        return S
    mesh = S.mesh
    dev = S.device if device is None else _device(device)
    nd = len(mesh.factors)
    lead = len(S.shape) - nd
    if mesh.distributed:
        from .comm import Move

        to = _receivers(mesh, dst)
        moves = [Move(mesh.owner(b), q, S.blocks[b], S.block_shape, S.dtype,
                      dev) for b in range(mesh.size) for q in to]
        got = mesh.transfer(moves)
        if mesh.rank not in to:
            return None
        blocks = [got[b * len(to) + to.index(mesh.rank)]
                  for b in range(mesh.size)]
    else:
        blocks = [b.to(dev) for b in S.blocks]
    parts = np.empty(len(blocks), dtype=object)
    for i, b in enumerate(blocks):
        parts[i] = b
    parts = parts.reshape(mesh.factors)
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


def _overlap(box, rng):
    """The part of ``box`` inside the block of range ``rng`` (None where
    they do not overlap)."""
    cut = [(max(a, lo), min(b, hi)) for (a, b), (lo, hi) in zip(box, rng)]
    return None if any(c0 >= c1 for c0, c1 in cut) else cut


def region(S: Sharded, box, device=None, dst="all") -> Optional[torch.Tensor]:
    """The box of the global grid (``box``: a ``(lo, hi)`` a grid axis, in
    global cell indices; past the grid's edges the edge cells repeat) as a
    new tensor on ``device`` (this process's first shard's by default),
    its leading axes whole, assembled from the blocks that overlap it, each
    overlap copied once.  On a mesh of several processes the box arrives
    on the ranks ``dst`` ("all", a rank or a list of ranks; each overlap
    goes from its block's owner to each of them) and is None on the
    others."""
    from .comm import Move

    mesh = S.mesh
    lead = len(S.shape) - len(mesh.factors)
    inside, clamp = _box_parts(S.grid_shape, box)
    dev = S.device if device is None else _device(device)
    to = _receivers(mesh, dst) if mesh.distributed else [mesh.rank]
    cuts, moves = [], []
    for b, rng in enumerate(S.ranges()):
        cut = _overlap(inside, rng)
        if cut is None:
            continue
        blk = S.blocks[b]
        src = None if blk is None else blk[(slice(None),) * lead + tuple(
            slice(c0 - lo, c1 - lo) for (c0, c1), (lo, _) in zip(cut, rng))]
        shape = tuple(S.shape[:lead]) + tuple(c1 - c0 for c0, c1 in cut)
        for q in to:
            cuts.append(cut)
            moves.append(Move(mesh.owner(b), q, src, shape, S.dtype, dev))
    got = mesh.transfer(moves)
    if mesh.rank not in to:
        return None
    out = torch.empty(tuple(S.shape[:lead]) + tuple(
        b - a for a, b in inside), dtype=S.dtype, device=dev)
    for cut, m, part in zip(cuts, moves, got):
        if m.dst == mesh.rank:
            out[(slice(None),) * lead + tuple(
                slice(c0 - a, c1 - a) for (c0, c1), (a, _)
                in zip(cut, inside))] = part
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
    """``S`` with each ``(box, value)`` or ``(box, value, rank)`` of
    ``writes`` written in (boxes inside the grid, in global cell indices;
    ``value`` a tensor of the box's shape on any device, held by ``rank``
    and None on the other ranks, or by every rank where no rank is named):
    a new :class:`Sharded` whose blocks that no box overlaps are ``S``'s
    own, and whose others are copies, written.  Each overlap goes from the
    value's rank to the block's owner, every write's overlaps in one
    phase."""
    from .comm import Move

    mesh = S.mesh
    nd = len(mesh.factors)
    lead = len(S.shape) - nd
    blocks = list(S.blocks)
    copied = set()
    targets, moves = [], []
    for w in writes:
        box, value = w[0], w[1]
        src = w[2] if len(w) > 2 else None
        for b, rng in enumerate(S.ranges()):
            cut = _overlap(box, rng)
            if cut is None:
                continue
            owner = mesh.owner(b)
            frm = owner if src is None else src
            part = None if value is None else value[
                (slice(None),) * lead + tuple(
                    slice(c0 - a, c1 - a) for (c0, c1), (a, _)
                    in zip(cut, box))]
            targets.append((b, cut, rng))
            moves.append(Move(frm, owner, part, tuple(S.shape[:lead]) + tuple(
                c1 - c0 for c0, c1 in cut), S.dtype, mesh.device(b)))
    got = mesh.transfer(moves)
    for (b, cut, rng), part in zip(targets, got):
        if part is None:
            continue
        if b not in copied:
            blocks[b] = blocks[b].clone()
            copied.add(b)
        blocks[b][(slice(None),) * lead + tuple(
            slice(c0 - lo, c1 - lo) for (c0, c1), (lo, _) in zip(cut, rng))
            ] = part
    return Sharded(blocks, S.mesh, S.shape)
