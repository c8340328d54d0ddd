"""Multi-device runs: a mesh of shards, one block of the grid a shard, each
a tensor on its device (:mod:`.mesh`), and the explicit exchange of ghost
strips between them (:mod:`.halo`).

One process drives every shard, as the JAX package's single controller
drives every device of its mesh: copies between shards are tensor copies
(peer copies between cards, slice copies when the shards share a device),
and the dt is a min over the shards.  Every shard of a mesh may sit on one
device, which is how one card (or the CPU) holds a 2x2x2 mesh.  A
nested-grid hierarchy puts every level on one mesh; its glue reads and
writes boxes across blocks (:func:`.mesh.region`,
:func:`.mesh.write_regions`).
"""
from .mesh import (AXIS_NAMES, Mesh, Sharded, decompose, gather, make_mesh,
                   mesh_requested, region, shard_state, visible_devices,
                   write_regions)

__all__ = ["AXIS_NAMES", "Mesh", "Sharded", "decompose", "gather",
           "make_mesh", "mesh_requested", "region", "shard_state",
           "visible_devices", "write_regions"]
