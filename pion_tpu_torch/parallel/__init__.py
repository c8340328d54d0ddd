"""Multi-device runs: a mesh of shards, one block of the grid a shard, each
a tensor on its device (:mod:`.mesh`), the explicit exchange of ghost
strips between them (:mod:`.halo`), and the transport between processes
(:mod:`.comm`).

In one process, one process drives every shard, as the JAX package's single
controller drives every device of its mesh: copies between shards are
tensor copies (peer copies between cards, slice copies when the shards
share a device), and the dt is a min over the shards.  Under a
``torch.distributed`` group a mesh spans the processes, one a card: each
process holds and steps its own shards, and what crosses a process goes
through :mod:`.comm` (a send and a receive, an all-reduce), with the same
result bit for bit.  Every shard of a mesh may sit on one
device, which is how one card (or the CPU) holds a 2x2x2 mesh.  A
nested-grid hierarchy puts every level on one mesh; its glue reads and
writes boxes across blocks (:func:`.mesh.region`,
:func:`.mesh.write_regions`).
"""
from . import comm
from .mesh import (AXIS_NAMES, Mesh, Sharded, decompose, gather, make_mesh,
                   mesh_requested, placement, region, shard_state,
                   visible_devices, write_regions)

__all__ = ["AXIS_NAMES", "Mesh", "Sharded", "comm", "decompose", "gather",
           "make_mesh", "mesh_requested", "placement", "region",
           "shard_state", "visible_devices", "write_regions"]
