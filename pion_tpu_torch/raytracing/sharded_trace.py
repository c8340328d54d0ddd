"""The sharded octant trace (B6): a point source's columns over a 3D grid
sharded on a 2x2x2 mesh, with no gather.

Counterpart of ``sharded_octant_trace`` / ``supports_sharded`` of
``pion_tpu/raytracing/pallas_trace.py`` (the causal pipeline of the
reference's parallel raytracer, raytracer_SC_pllel.cpp:156-221).  With the
source in cell n/2 - 1 of every axis, each octant of the sweep is one
shard's block plus, along each axis where the shard lies above the source,
one ghost plane: the source plane, held by its lower neighbour.  So, per
axis in turn, each lower shard's top plane goes to its upper neighbour
(taken from the neighbour's block as already padded along the axes before,
so edges and corners arrive), B5 (:func:`.fused_trace.octant_trace`) traces
each shard's padded block from the source corner, and the ghost planes are
dropped.  The values are the single-device trace's.

The TPU kernel flips every block so that one SPMD program serves all shards;
B5 takes the source in any cell, so here each block is traced with its own
corner as the source and nothing is flipped.  The planes cross as tensor
copies (a peer copy between two cards, a slice copy on one), or between
processes as sends and receives of :mod:`..parallel.comm`.  The eight
launches run one after another on the current stream.

:func:`sharded_octant_trace` launches B5 per shard for CUDA blocks (and
counts its own launches in ``launches``); for CPU blocks it takes
:func:`sharded_octant_trace_plain`, the same exchange with the plain trace
per block.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import fused_trace


def supports_sharded(shape: Sequence[int], src_idx: Sequence[int],
                     mesh) -> bool:
    """Whether B6 takes the trace: a 3D grid, a 2x2x2 mesh, even sizes and
    the source in cell n/2 - 1 of every axis (the JAX gate without its
    float32 and VMEM terms)."""
    if len(shape) != 3 or tuple(mesh.factors) != (2, 2, 2):
        return False
    return all(shape[a] % 2 == 0 and src_idx[a] == shape[a] // 2 - 1
               for a in range(3))


def _exchange(blocks: Sequence[Optional[torch.Tensor]], mesh):
    """Every block of this process with the source planes it needs: per
    axis in turn, each upper shard takes its lower neighbour's top plane as
    a ghost plane in front, from the neighbour's block as padded along the
    axes before (the planes of one axis in one phase of moves,
    :meth:`..parallel.mesh.Mesh.transfer`).  Returns the padded blocks
    (None at other processes' shards) and each one's source cell."""
    from ..parallel.comm import Move

    cubes = list(blocks)
    base = blocks[mesh.local[0]]
    for a in range(3):
        keys, moves = [], []
        for b, coord in enumerate(mesh.coords):
            if coord[a] != 1:
                continue
            nb = mesh.neighbour(b, a, -1)
            # the neighbour's shape so far: one plane more along each
            # earlier axis where it (as ``b``) lies above the source
            shape = tuple(1 if x == a else n + (x < a and coord[x] == 1)
                          for x, n in enumerate(base.shape))
            top = cubes[nb]
            if top is not None:
                top = top.narrow(a, top.shape[a] - 1, 1)
            keys.append(b)
            moves.append(Move(mesh.owner(nb), mesh.owner(b), top, shape,
                              base.dtype, mesh.device(b)))
        for b, plane in zip(keys, mesh.transfer(moves)):
            if plane is not None:
                cubes[b] = torch.cat([plane, cubes[b]], dim=a)
    srcs = [tuple(0 if c else base.shape[a] - 1
                  for a, c in enumerate(coord))
            for coord in mesh.coords]
    return cubes, srcs


def _drop_ghosts(col: torch.Tensor, coord) -> torch.Tensor:
    for a, c in enumerate(coord):
        if c:
            col = col.narrow(a, 1, col.shape[a] - 1)
    return col.contiguous()


def _check(blocks, mesh):
    if len(blocks) != 8 or tuple(mesh.factors) != (2, 2, 2):
        raise ValueError("the sharded octant trace takes the 8 blocks of a "
                         "2x2x2 mesh")
    own = [blocks[b] for b in mesh.local]
    shape = tuple(own[0].shape)
    if len(shape) != 3 or any(tuple(b.shape) != shape for b in own):
        raise ValueError("the blocks must be 3D and of one shape, got "
                         f"{[tuple(b.shape) for b in own]}")
    return own


def sharded_octant_trace(blocks: Sequence[torch.Tensor], mesh,
                         tau_min: float) -> List[torch.Tensor]:
    """``col`` (the optical depth to each cell's exit) of a source in cell
    n/2 - 1 of every axis, for ``blocks`` (the per-cell optical depths of
    the 8 shards, in the mesh's order): one B5 launch a shard on its device
    and current stream.  CPU blocks take
    :func:`sharded_octant_trace_plain`; a mesh of CUDA blocks launches or
    raises.  On a mesh of several processes each launches B5 on its own
    blocks (None at the others'), and the trace counts as launched on the
    process that owns shard 0, so that the counts summed over the
    processes are one process's."""
    own = _check(blocks, mesh)
    if not own[0].is_cuda:
        return sharded_octant_trace_plain(blocks, mesh, tau_min)
    if not all(b.is_cuda for b in own):
        raise ValueError("the shards of a sharded trace are all on CUDA "
                         "devices or all on the CPU")
    cubes, srcs = _exchange(blocks, mesh)
    out = [None] * mesh.size
    for b in mesh.local:
        with torch.cuda.device(cubes[b].device):
            col = fused_trace.octant_trace(cubes[b], srcs[b], tau_min)
        out[b] = _drop_ghosts(col, mesh.coords[b])
    if mesh.owns(0):
        sharded_octant_trace.launches += 1
    return out


sharded_octant_trace.launches = 0


def sharded_octant_trace_plain(blocks: Sequence[torch.Tensor], mesh,
                               tau_min: float) -> List[torch.Tensor]:
    """The plain PyTorch version of :func:`sharded_octant_trace`: the same
    exchange, :func:`.fused_trace.octant_trace_plain` per block."""
    _check(blocks, mesh)
    cubes, srcs = _exchange(blocks, mesh)
    return [None if cube is None else _drop_ghosts(
        fused_trace.octant_trace_plain(cube, src, tau_min), coord)
        for cube, src, coord in zip(cubes, srcs, mesh.coords)]
