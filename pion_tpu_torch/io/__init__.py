"""Snapshot / checkpoint I/O of the port (the same on-disk formats as the
JAX package's)."""
from .snapshot import (AsyncSnapshotWriter, load_snapshot,  # noqa: F401
                       load_snapshot_raw, save_snapshot)
