"""Snapshot / checkpoint I/O.

Equivalent of the reference's Silo/FITS snapshot stack
(reference: source/dataIO/dataio_base.h:23-67; every snapshot is a full
restart file: header parameters + all prognostic fields, and restart
auto-detects the format — main.cpp:99-112).  The two on-disk formats are
those of the JAX package, so a run written by either package restarts in
the other:

- ``.snap``: the magic ``PTSNAP2\\0``, the header's length as 8 little-endian
  bytes, the JSON header, then the field as chunked deflate —
  ``[int64 n_chunks][int64 raw_chunk_bytes][int64 comp_size x n_chunks]``
  followed by one zlib stream per 4 MiB chunk of the raw array.  The JAX
  package writes it through a small C++ library; here it is Python's
  ``zlib``, which releases the interpreter lock, on a thread pool.
- ``.npz``: ``numpy.savez_compressed`` of the field ``P`` and the JSON header
  as bytes.

The header's ``config`` is the JSON of the reference's ``SimConfig`` dict;
the port's ``kernels`` field crosses as the reference's ``pallas`` field
(:func:`..convert.config_to_reference` / ``config_from_reference``).  A
multi-level snapshot stacks the levels on a leading axis.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig

FORMAT_VERSION = 1
_MAGIC = b"PTSNAP2\x00"
_CHUNK = 4 << 20   # raw bytes per deflate stream
_LEVEL = 1         # deflate level of the reference's writer


def _cfg_to_json(cfg: SimConfig) -> str:
    from ..convert import config_to_reference

    return json.dumps(config_to_reference(cfg))


def _cfg_from_json(s: str) -> SimConfig:
    from ..convert import config_from_reference

    return config_from_reference(json.loads(s))


def _host_array(P) -> np.ndarray:
    if isinstance(P, torch.Tensor):
        return P.detach().cpu().numpy()
    return np.asarray(P)


def _n_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def _compress(P: np.ndarray) -> bytes:
    raw = memoryview(np.ascontiguousarray(P)).cast("B")
    n = len(raw)
    n_chunks = (n + _CHUNK - 1) // _CHUNK
    with ThreadPoolExecutor(_n_threads()) as pool:
        parts = list(pool.map(
            lambda i: zlib.compress(raw[i * _CHUNK:(i + 1) * _CHUNK], _LEVEL),
            range(n_chunks)))
    sizes = np.array([n_chunks, _CHUNK] + [len(p) for p in parts],
                     dtype="<i8")
    return sizes.tobytes() + b"".join(parts)


def _decompress(blob: bytes, raw_nbytes: int) -> np.ndarray:
    if len(blob) < 16:
        raise IOError("snapshot payload is cut short")
    n_chunks, chunk = (int(v) for v in np.frombuffer(blob, "<i8", 2))
    if n_chunks <= 0 or chunk <= 0 or len(blob) < 16 + 8 * n_chunks:
        raise IOError("snapshot payload has a bad chunk table")
    sizes = np.frombuffer(blob, "<i8", n_chunks, offset=16)
    offs = 16 + 8 * n_chunks + np.concatenate([[0], np.cumsum(sizes)])
    if int(offs[-1]) > len(blob) or (n_chunks - 1) * chunk >= raw_nbytes:
        raise IOError("snapshot payload does not match its header")
    view = memoryview(blob)
    with ThreadPoolExecutor(_n_threads()) as pool:
        parts = list(pool.map(
            lambda i: zlib.decompress(view[int(offs[i]):int(offs[i + 1])]),
            range(n_chunks)))
    raw = b"".join(parts)
    if len(raw) != raw_nbytes:
        raise IOError(f"snapshot payload holds {len(raw)} bytes, the header "
                      f"says {raw_nbytes}")
    # a copy: the caller gets a writable array
    return np.frombuffer(raw, dtype=np.uint8).copy()


def save_snapshot(path: str, P, cfg: SimConfig, t: float, step: int = 0,
                  extra: Optional[dict] = None) -> str:
    """Write one snapshot; returns the final path.

    ``P`` is a tensor or an array ``(nvar, *shape)``, with a leading level
    axis when ``cfg.nlevels > 1``.  A path that ends in ``.npz`` is written
    as ``.npz``; any other gets the ``.snap`` format (and suffix).  The file
    appears under its name only when it is complete."""
    header = {
        "format_version": FORMAT_VERSION,
        "config": _cfg_to_json(cfg),
        "t": float(t),
        "step": int(step),
    }
    if extra:
        header["extra"] = extra
    P = _host_array(P)
    expect = (cfg.nvar,) + cfg.shape
    if cfg.nlevels > 1:
        expect = (cfg.nlevels,) + expect
    if P.shape != expect:
        raise ValueError(
            f"snapshot state shape {P.shape} does not match the config "
            f"(nvar={cfg.nvar}, shape={cfg.shape}, nlevels={cfg.nlevels}; "
            f"expected {expect}) — the IC generator and SimConfig disagree")

    tmp = path + ".tmp"
    if path.endswith(".npz"):
        arrays = {"P": P, "header": np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8)}
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
    else:
        if not path.endswith(".snap"):
            path = path + ".snap"
            tmp = path + ".tmp"
        header["dtype"] = str(P.dtype)
        header["shape"] = list(P.shape)
        hj = json.dumps(header).encode()
        blob = _compress(P)
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(len(hj).to_bytes(8, "little"))
            f.write(hj)
            f.write(blob)
    os.replace(tmp, path)  # atomic, like the checkpoint rotation
    return path


class AsyncSnapshotWriter:
    """Background snapshot writer.

    The reference hides checkpoint latency behind PMPIO's grouped parallel
    writes (reference: dataIO/dataio_silo_MPI.cpp:7-17); here the same role
    is a host worker thread: the step loop hands off the already-fetched
    host array and keeps stepping while compression + disk I/O run behind
    it.  A bounded queue (default depth 2, matching the two rolling
    checkpoint files of sim_init.cpp:681-700) applies back-pressure when
    the disk cannot keep up.  Worker exceptions are re-raised on the next
    ``submit``/``wait``.
    """

    def __init__(self, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                save_snapshot(*item)
            except Exception as e:  # surfaced on submit/wait
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, path: str, P, cfg: SimConfig, t: float,
               step: int = 0, extra: Optional[dict] = None):
        self._check()
        # on the host NOW (a device tensor is copied; a host one too), so
        # the caller may rebind or overwrite its state
        self._q.put((path, np.array(_host_array(P)), cfg, float(t),
                     int(step), extra))

    def wait(self):
        """Block until all submitted snapshots are on disk."""
        self._q.join()
        self._check()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()


def load_snapshot(path: str) -> Tuple[SimConfig, np.ndarray, float, int]:
    """Back-compat loader: (cfg, P, t, step)."""
    cfg, P, t, step, _extra = load_snapshot_raw(path)
    return cfg, P, t, step


def load_snapshot_raw(
        path: str) -> Tuple[SimConfig, np.ndarray, float, int, Optional[dict]]:
    """``(cfg, P, t, step, extra)`` of a snapshot in either format; ``path``
    may leave the suffix out."""
    for suffix in ("", ".snap", ".npz"):
        if os.path.exists(path + suffix):
            path = path + suffix
            break
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic == _MAGIC:
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
            blob = f.read()
    if magic == _MAGIC:
        dtype = np.dtype(header["dtype"])
        shape = tuple(header["shape"])
        nbytes = dtype.itemsize * int(np.prod(shape))
        P = _decompress(blob, nbytes).view(dtype).reshape(shape)
    else:
        with np.load(path) as z:
            header = json.loads(bytes(z["header"]).decode())
            P = z["P"]
    cfg = _cfg_from_json(header["config"])
    return cfg, P, header["t"], header["step"], header.get("extra")
