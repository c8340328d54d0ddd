"""The explicit halo exchange of a sharded run.

Counterpart of ``pion_tpu/parallel/halo.py`` (its ``shard_map`` +
``ppermute`` path), the hand-scheduled equivalent of the reference's MPI
halo machinery (reference: source/boundaries/MCMD_boundaries.cpp pack ->
``COMM->send_cell_data``/``receive_cell_data`` -> unpack): each shard pads
its block with ghost strips taken from its mesh neighbours, applies the
physical boundary conditions only where it owns a domain edge, and runs the
sweep (the CUDA kernels B1/B2 on a card, as on one device) on its padded
block.  A strip crosses as a tensor copy: a peer copy between two cards
(``Tensor.to(device, non_blocking=True)``, on the current stream), a slice
copy when both shards share a device; between processes, a send and a
receive of :mod:`.comm`, the strips of one axis in one phase
(:func:`neighbour_strips`).  The dt is a min over the shards, the
reference's MPI_Allreduce (sim_control_MPI.cpp:503-504).

A shard that owns a domain face fills its ghosts there as the whole grid
does, from its own data and the whole grid's positions (its
``BoundaryData.block``): the double-Mach shock's foot and moving top face,
the jet's nozzle, the INFLOW/FIXED strips sliced to the block.  A
cylindrical or spherical grid steps on its blocks with the whole grid's
geometry sliced (``grid.block_geometry``).  ``halo="explicit"`` keeps the
JAX package's guards of its explicit-halo mode (:func:`check_explicit`):
pure dynamics, local-data BCs, Cartesian.  The time-stepping itself is
``stepper.make_step_fns`` with a mesh: the same partial update on every
shard's block.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..boundaries import BC, BoundaryData, _pad_axis, axis_ghosts
from ..config import SimConfig
from ..constants import Coord
from ..grid import Geometry
from ..stepper import _on
from .mesh import Mesh, Sharded

_LOCAL_BCS = (BC.PERIODIC, BC.OUTFLOW, BC.ONEWAY_OUT, BC.REFLECTING,
              BC.JETREFLECT, BC.AXISYMMETRIC)


def supports(cfg: SimConfig) -> bool:
    return all(lo in _LOCAL_BCS and hi in _LOCAL_BCS for lo, hi in cfg.bcs)


def check_explicit(cfg: SimConfig):
    """The JAX package's guards of ``halo="explicit"``
    (``pion_tpu/parallel/halo.py:41,113``): BCs whose ghosts are local edge
    data and a Cartesian grid; a sharded run without that option takes
    every face and geometry."""
    if not supports(cfg):
        raise NotImplementedError(
            "halo='explicit' requires local-data BCs "
            "(periodic/outflow/oneway/reflecting/jetreflect/axisym); "
            "without it a sharded run takes DMACH, JET and fixed strips")
    if cfg.coords is not Coord.CARTESIAN:
        raise NotImplementedError(
            "halo='explicit' is Cartesian only, as in the JAX package; "
            "without it a sharded run takes cylindrical and spherical grids")


def local_config(cfg: SimConfig, mesh: Mesh) -> SimConfig:
    """The config of one shard's block: the block's shape, with exactly the
    global ``dx`` (only ``dx`` is read of a Cartesian block's extent)."""
    shape = mesh.block_shape(cfg.shape)
    dx = cfg.dx
    hi = cfg.xmin[-1] + dx * shape[-1]
    for _ in range(8):       # a last-bit nudge where the sum rounds off
        got = (hi - cfg.xmin[-1]) / shape[-1]
        if got == dx:
            break
        hi = float(np.nextafter(hi, np.inf if got < dx else -np.inf))
    xmax = tuple(cfg.xmin[a] + dx * shape[a] for a in range(cfg.ndim - 1))
    out = cfg.with_(shape=shape, xmax=xmax + (hi,))
    if out.dx != dx:
        raise ValueError(f"no block extent gives dx = {dx!r} exactly")
    return out


def neighbour_strips(blocks: List[Optional[torch.Tensor]], mesh: Mesh,
                     axis: int, ng: int, takes) -> dict:
    """The ghost strips that cross between shards along ``axis``, in one
    phase of moves (:meth:`.mesh.Mesh.transfer`): for every shard ``b`` and
    side (0 low, 1 high) where ``takes(b, side)``, its lower neighbour's
    top ``ng`` planes or its upper neighbour's bottom ones (round the
    ring).  ``blocks``: one a shard (None at other processes' shards), all
    of one shape.  Returns ``{(b, side): strip}`` for this process's
    shards, each strip on its block's device."""
    from .comm import Move

    ax = 1 + axis
    like = blocks[mesh.local[0]]
    shape = tuple(ng if d == ax else n for d, n in enumerate(like.shape))
    keys, moves = [], []
    for b in range(mesh.size):
        for side in (0, 1):
            if not takes(b, side):
                continue
            nb = mesh.neighbour(b, axis, 2 * side - 1)
            src = blocks[nb]
            if src is not None:
                src = (src.narrow(ax, src.shape[ax] - ng, ng) if side == 0
                       else src.narrow(ax, 0, ng))
            keys.append((b, side))
            moves.append(Move(mesh.owner(nb), mesh.owner(b), src, shape,
                              like.dtype, mesh.device(b)))
    return {k: v for k, v in zip(keys, mesh.transfer(moves))
            if v is not None}


def _pad_axis_sharded(blocks: List[Optional[torch.Tensor]], cfg: SimConfig,
                      axis: int, bdatas, mesh: Mesh, t) -> List:
    """Pad one axis of every block of this process: a shard's low ghosts
    are its lower neighbour's top ``ng`` planes and its high ghosts its
    upper neighbour's bottom ones (round the ring, so a periodic face
    wraps; :func:`neighbour_strips`); a shard that owns a non-periodic
    domain face takes the physical BC's ghosts there."""
    ng = cfg.ng
    ax = 1 + axis
    m = mesh.factors[axis]
    lo_kind, hi_kind = cfg.bcs[axis]

    def own(b, side):
        i = mesh.coords[b][axis]
        return (i == 0 and lo_kind is not BC.PERIODIC if side == 0
                else i == m - 1 and hi_kind is not BC.PERIODIC)

    strips = neighbour_strips(blocks, mesh, axis, ng,
                              lambda b, side: not own(b, side))
    out = [None] * mesh.size
    for b in mesh.local:
        blk = blocks[b]
        if own(b, 0) or own(b, 1):
            lo_bc, hi_bc = axis_ghosts(blk, cfg, axis, bdatas[b],
                                       t=_on(t, blk))
        lo = lo_bc if own(b, 0) else strips[(b, 0)]
        hi = hi_bc if own(b, 1) else strips[(b, 1)]
        out[b] = torch.cat([lo, blk, hi], dim=ax)
    return out


def block_bdatas(bdata: Optional[BoundaryData], cfg: SimConfig,
                 mesh: Mesh) -> List[BoundaryData]:
    """``bdata`` of the whole grid of config ``cfg`` as one
    ``BoundaryData.block`` a shard."""
    bdata = BoundaryData() if bdata is None else bdata
    return [bdata.block(cfg, r) for r in mesh.ranges(cfg.shape)]


def apply_bcs_sharded(P: Sharded, cfg: SimConfig, bdata=None,
                      mesh: Optional[Mesh] = None, t=0.0) -> List[torch.Tensor]:
    """Every block of this process padded with ``ng`` ghost layers on each
    face, None at other processes' shards (``cfg`` is the blocks' config, :func:`local_config`; ``bdata`` one
    ``BoundaryData`` a shard, :func:`block_bdatas`, or one for every shard
    where no face reads positions or strips).  Axes are padded in order,
    each from the blocks padded along the axes before it, so edge and
    corner ghosts arrive as ``boundaries.apply_bcs`` fills them on the
    whole grid: the result is that of the whole grid, sliced."""
    mesh = P.mesh if mesh is None else mesh
    if not isinstance(bdata, (list, tuple)):
        bdata = [BoundaryData() if bdata is None else bdata] * mesh.size
    out = list(P.blocks)
    for axis in range(cfg.ndim):
        if mesh.factors[axis] == 1:
            out = [None if blk is None
                   else _pad_axis(blk, cfg, axis, bd, t=_on(t, blk))
                   for blk, bd in zip(out, bdata)]
        else:
            out = _pad_axis_sharded(out, cfg, axis, bdata, mesh, t)
    return out


def make_sharded_step(cfg: SimConfig, geom: Geometry, mesh: Mesh,
                      bdata: Optional[BoundaryData] = None):
    """``(advance, calc_dt)`` of a pure-dynamics run on ``mesh`` (the JAX
    package's ``make_sharded_step``): ``advance(P, dt, t)`` and
    ``calc_dt(P)`` take a :class:`Sharded` state (or a whole tensor, which
    they shard), the dt a min over the shards."""
    from ..stepper import make_step_fns

    fns = make_step_fns(cfg, geom, bdata, mesh=mesh)
    return fns.advance, fns.calc_dt
