"""The transport between the processes of a mesh: the one module that calls
``torch.distributed``.

Counterpart of the JAX package's ``maybe_distributed_init``
(``pion_tpu/parallel/mesh.py:131-153``) and of the transfers XLA emits for
a global array whose shards live in several processes; the reference's MPI
layer (reference: source/decomposition/MCMD_control.cpp, ``COMM->init`` of
main_NG_MPI.cpp:40-60, and the pack/send/receive/unpack of
MCMD_boundaries.cpp).  One process drives the shards of one card (or of
the CPU); every process runs the same program on the blocks it owns
(:class:`.mesh.Mesh` knows each shard's owner), and what crosses a process
goes through here:

- :func:`transfer`: a phase of point-to-point moves.  Each move names its
  source and destination rank and the part's shape and dtype, which every
  rank computes from the box arithmetic; every rank lists the same moves
  in the same order and posts its own sends and receives of the phase in
  one ``batch_isend_irecv`` (never a blocking send/recv loop: two ranks
  that both sent first would deadlock).  A move within one process is the
  ``Tensor.to(device, non_blocking=True)`` of a one-process mesh.
- :func:`all_reduce` of a min, a max or a sum: the dt, the chemistry
  ladder's stiffness and Newton test, cell counts; the local reduction
  over a process's shards comes first, so nothing reassociates.

The backend is NCCL for a rank on a card and gloo for a rank on the CPU,
unless the caller names one; there is no quiet fallback from one to the
other.  NCCL moves device tensors.  gloo moves host tensors: a strip of a
CUDA block is copied to the host, sent, and copied to the receiver's card.
That is also the only way for two processes that share one card to
exchange, since NCCL refuses two ranks on one device.

The counters ``comm.bytes_sent`` and ``comm.messages`` of
:mod:`..tracing` count what this process sent to other processes.
"""
from __future__ import annotations

import datetime
import os
from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import tracing

_state = {"device": None, "started_here": False}


def _dist():
    import torch.distributed as dist

    return dist


def initialized() -> bool:
    """Whether a process group is up."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return _dist().get_rank() if initialized() else 0


def world_size() -> int:
    return _dist().get_world_size() if initialized() else 1


def backend() -> Optional[str]:
    return str(_dist().get_backend()) if initialized() else None


def local_device() -> torch.device:
    """This process's device in a group: the one named at
    :func:`init_distributed`, else card ``LOCAL_RANK`` where there is a
    card, else the CPU."""
    if _state["device"] is not None:
        return _state["device"]
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def init_distributed(backend: Optional[str] = None,
                     init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     device=None, timeout_s: float = 600.0) -> bool:
    """Start the process group (idempotent: a group already up is kept).
    ``device``: this rank's device (a card's index becomes the current
    device); by default card ``LOCAL_RANK`` where there is a card, else the
    CPU.  ``backend``: NCCL for a rank on a card and gloo for one on the
    CPU unless named.  ``rank`` and ``world_size`` default to the
    launcher's ``RANK`` and ``WORLD_SIZE``; ``timeout_s`` bounds every
    wait, so that a rank that died brings the others down.  Returns
    whether this call started the group."""
    dev = torch.device(device) if device is not None else local_device()
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    _state["device"] = dev
    if initialized():
        return False
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    _dist().init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _state["started_here"] = True
    return True


def maybe_distributed_init(device=None) -> bool:
    """The JAX package's ``maybe_distributed_init``: start the group when
    the launcher's environment says there are several processes
    (torchrun's ``WORLD_SIZE`` > 1, with ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``), on ``device`` (see
    :func:`init_distributed`); do nothing otherwise.  Idempotent.  Returns
    whether the run spans several processes."""
    if initialized():
        return world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1") or 1) <= 1:
        return False
    init_distributed(device=device)
    return True


def destroy():
    """Take down the group this module started (a no-op otherwise)."""
    if initialized() and _state["started_here"]:
        _dist().destroy_process_group()
        _state["started_here"] = False


class Move(NamedTuple):
    """One part of a :func:`transfer`: ``send`` (the tensor, on the source
    rank; None elsewhere) goes from rank ``src`` to rank ``dst``, where it
    arrives as a tensor of ``shape`` and ``dtype`` on ``device``."""
    src: int
    dst: int
    send: Optional[torch.Tensor]
    shape: tuple
    dtype: torch.dtype
    device: Optional[torch.device]


def _host() -> bool:
    return backend() == "gloo"


def transfer(moves: Sequence[Move]) -> List[Optional[torch.Tensor]]:
    """One phase of moves, listed alike on every rank.  Returns, move by
    move, the tensor that arrived where this rank is the destination (on
    the move's device), else None.  A move within this process is a
    ``Tensor.to``; the others are posted in one ``batch_isend_irecv``,
    tagged by their place in the list, and waited for."""
    me = rank()
    out: List[Optional[torch.Tensor]] = [None] * len(moves)
    ops, arriving = [], []
    dist = _dist() if initialized() else None
    for k, m in enumerate(moves):
        if m.src == me and m.dst == me:
            out[k] = m.send.to(m.device, non_blocking=True)
        elif m.src == me:
            t = m.send.detach().to("cpu" if _host() else m.send.device,
                                   m.dtype).contiguous()
            ops.append(dist.P2POp(dist.isend, t, m.dst, tag=k))
            tracing.count("comm.bytes_sent", t.numel() * t.element_size())
            tracing.count("comm.messages")
        elif m.dst == me:
            buf = torch.empty(m.shape, dtype=m.dtype,
                              device="cpu" if _host() else m.device)
            ops.append(dist.P2POp(dist.irecv, buf, m.src, tag=k))
            arriving.append((k, buf, m.device))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for k, buf, dev in arriving:
        out[k] = buf.to(dev)
    return out


_OPS = {"min": "MIN", "max": "MAX", "sum": "SUM"}


def all_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """``op`` ("min", "max" or "sum") of ``x`` over every rank, as a new
    tensor on ``x``'s device (gloo: through the host)."""
    if not initialized():
        return x
    dist = _dist()
    t = x.detach().to("cpu").clone() if _host() else x.detach().clone()
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]))
    return t.to(x.device) if _host() else t


def all_reduce_ints(values: Sequence[int], op: str) -> List[int]:
    """``op`` of a few host integers over every rank."""
    if not initialized():
        return [int(v) for v in values]
    dev = "cpu" if _host() else local_device()
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    return [int(v) for v in all_reduce(t, op).tolist()]


def barrier():
    """Wait until every rank has come here."""
    if initialized():
        _dist().barrier()
