"""Fused point-source trace: wrapper, launch plan and plain version.

CUDA kernels (source in ``csrc/trace.cu``) take the place of the TPU
kernel ``_octant_kernel_3d`` of ``pion_tpu/raytracing/pallas_trace.py`` and
of its host-side wrapper ``OctantSweep3D``: :func:`octant_trace` returns
``col``, the optical depth from the source to every cell's exit, by the
C2Ray short-characteristics interpolation (Mellema et al. 2006 eq. A5), for
a source in any cell of an ``(nz, ny, nx)`` grid (``nz = 1`` for a 2D grid).

:func:`trace_plan` says how a launch runs: plan ``"cluster"`` gives each
octant a thread-block cluster that keeps three Chebyshev shells in shared
memory; plan ``"global"`` (one block an octant, working in device memory) is
kept for octants whose shells no cluster can hold.  The plan is chosen by
shape alone.

Beside them stands the plain PyTorch version, :func:`octant_trace_plain`:
the same sweep as dense plane operations, Chebyshev shell by shell, the two
z-faces, the two y-faces, then the two x-faces.  The wrapper takes the plain
version only because the tensor it was given lies on the CPU; for a CUDA
tensor it launches a kernel or raises.  The wrapper counts its launches in
its ``launches`` attribute.  What bounds the kernels on an H100 is written
at the head of ``csrc/trace.cu``.
"""
from __future__ import annotations

import functools
from types import MappingProxyType
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

TRACE_THREADS = 1024           # most threads a block
SMEM_MAX = 232448              # shared memory a block can opt in to (H100)
MAX_CLUSTER = 16               # blocks a cluster (above 8: non-portable)
# blocks a cluster the plan starts from: the size measured fastest on the
# 128^3 centred trace (H100, 700 W: 1 0.84, 2 0.59, 4 0.46, 8 0.39, 16 0.40
# ms; PERF.md, B5); trace_plan takes MAX_CLUSTER where the shells do not fit
# or a face needs more than a cell a thread (the corner trace: 8 1.12, 16
# 0.89 ms)
TRACE_CLUSTER = 8


def supports(shape: Sequence[int], src_idx: Sequence[int], dtype) -> bool:
    """Whether the kernel covers this trace: a 3D array (a 2D grid as a slab
    one cell deep), the source in a cell of the grid, float32 or float64."""
    return (len(shape) == 3 and len(src_idx) == 3
            and all(n >= 1 for n in shape)
            and all(0 <= s < n for s, n in zip(src_idx, shape))
            and dtype in (torch.float32, torch.float64))


def octant_sizes(shape: Sequence[int],
                 src: Sequence[int]) -> Tuple[Tuple[int, int, int], ...]:
    """Cells along z, y, x of the eight octants, from the source plane
    outward; octant ``o`` sweeps toward +a where bit ``a`` of ``o`` is set
    (the kernels' numbering)."""
    return tuple(tuple(shape[a] - src[a] if (o >> a) & 1 else src[a] + 1
                       for a in range(3)) for o in range(8))


def face_cells(size: Sequence[int], s) -> Tuple[np.ndarray, ...]:
    """``(n1, n2)`` of the z-, y- and x-face of shell(s) ``s`` of an octant
    of ``size`` (``face_dims`` of ``csrc/trace.cu``): the z-face holds z = s,
    y < s, x < s; the y-face y = s, z <= s, x < s; the x-face x = s,
    z <= s, y <= s.  Zero where the face lies outside the octant; shell 0
    is the source cell, on its x-face."""
    s = np.asarray(s)
    z, y, x = size
    dims = ((np.minimum(s, y), np.minimum(s, x)),
            (np.minimum(s + 1, z), np.minimum(s, x)),
            (np.minimum(s + 1, z), np.minimum(s + 1, y)))
    return tuple((np.where(s < size[a], n1, 0), np.where(s < size[a], n2, 0))
                 for a, (n1, n2) in enumerate(dims))


def shell_slots(size: Sequence[int], s, cluster: int) -> np.ndarray:
    """Slots block 0 of a cluster of ``cluster`` blocks keeps for each face
    of shell(s) ``s`` (the most any block keeps): the faces are dealt out by
    rows, row ``i1`` to block ``i1 % cluster``, at slot ``(i1 // cluster) *
    n2 + i2`` of the block's part of that face.  Shape ``(3,) +
    shape(s)``."""
    return np.stack([-(-n1 // cluster) * n2
                     for n1, n2 in face_cells(size, s)])


@functools.lru_cache(maxsize=None)
def trace_plan(shape: Tuple[int, int, int], src: Tuple[int, int, int],
               itemsize: int) -> Mapping[str, object]:
    """How :func:`octant_trace` launches for a grid of ``shape`` (nz, ny, nx)
    with the source in cell ``src``, for a scalar of ``itemsize`` bytes.

    Plan ``"cluster"``: one cluster of ``cluster`` blocks of ``threads`` an
    octant (``blocks`` = 8 clusters), each block holding three shell
    buffers of ``cap`` slots (``smem`` bytes: the most any block of any
    octant needs).  The cluster size is ``TRACE_CLUSTER`` where its blocks'
    shells fit ``SMEM_MAX`` and its largest share of a face is one cell a
    thread (at most ``TRACE_THREADS`` cells), else ``MAX_CLUSTER`` where
    its shells fit; ``threads`` covers that share in one round, at most
    ``TRACE_THREADS``.  Plan ``"global"``: where not even ``MAX_CLUSTER``
    blocks hold the shells, one block of ``TRACE_THREADS`` an octant in
    device memory.  Cached: it runs on every launch."""
    if (len(shape) != 3 or len(src) != 3 or any(n < 1 for n in shape)
            or not all(0 <= s < n for s, n in zip(src, shape))
            or itemsize not in (4, 8)):
        raise ValueError(f"bad trace of shape {tuple(shape)}, source "
                         f"{tuple(src)}, itemsize {itemsize}")
    sizes = octant_sizes(shape, src)
    shells = max(max(size) for size in sizes)    # shells 0 .. shells - 1
    fits = []
    for c in (TRACE_CLUSTER, MAX_CLUSTER):
        slots = [shell_slots(size, np.arange(max(size)), c) for size in sizes]
        cap = max(int(sl.sum(axis=0).max()) for sl in slots)
        share = max(int(sl.max()) for sl in slots)
        if 3 * cap * itemsize <= SMEM_MAX:
            fits.append((c, cap, share))
    if not fits:
        return MappingProxyType({
            "plan": "global", "cluster": 1, "blocks": 8,
            "threads": TRACE_THREADS, "cap": 0, "smem": 0,
            "shells": shells})
    # the first that gives each thread at most one cell of a face
    c, cap, share = next((f for f in fits if f[2] <= TRACE_THREADS),
                         fits[-1])
    return MappingProxyType({
        "plan": "cluster", "cluster": c, "blocks": 8 * c,
        "threads": min(TRACE_THREADS, -(-share // 32) * 32), "cap": cap,
        "smem": 3 * cap * itemsize, "shells": shells})


_PLANS = {"global": 0, "cluster": 1}


def octant_trace(dtau: torch.Tensor, src_idx: Sequence[int],
                 tau_min: float) -> torch.Tensor:
    """``col`` of one point source: ``dtau`` is the per-cell optical depth
    increment ``(nz, ny, nx)``, ``src_idx`` the source cell, ``tau_min`` the
    floor of the interpolation weights.  ``col - dtau`` is the optical depth
    to each cell's entry.  A CPU tensor takes :func:`octant_trace_plain`; a
    CUDA tensor launches the kernel of :func:`trace_plan` or raises."""
    if not dtau.is_cuda:
        return octant_trace_plain(dtau, src_idx, tau_min)
    src = tuple(int(s) for s in src_idx)
    if not supports(dtau.shape, src, dtau.dtype):
        raise ValueError(
            f"trace of shape {tuple(dtau.shape)} {dtau.dtype} with source "
            f"cell {src} is outside fused_trace.supports()")
    from .. import _build

    dtau = dtau.contiguous()
    plan = trace_plan(tuple(dtau.shape), src, dtau.element_size())
    lib = _build.get_trace_lib(
        "float32" if dtau.dtype == torch.float32 else "float64")
    # every cell is written by the octant(s) it belongs to
    col = torch.empty_like(dtau)
    nz, ny, nx = dtau.shape
    err = lib.pion_octant_trace(
        dtau.data_ptr(), col.data_ptr(), nz, ny, nx, *src, float(tau_min),
        _PLANS[plan["plan"]], plan["cluster"], plan["threads"], plan["cap"],
        torch.cuda.current_stream(dtau.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"octant_trace kernel launch failed ({plan['plan']} plan, "
            f"cluster {plan['cluster']}): CUDA error {err}")
    octant_trace.launches += 1
    return col


octant_trace.launches = 0


def _toward(n: int, s: int, device) -> torch.Tensor:
    """Index of the neighbour one step toward source index ``s`` along an
    axis of length ``n``; the source row maps to itself."""
    i = torch.arange(n, device=device)
    return i - torch.sign(i - s)


def octant_trace_plain(dtau: torch.Tensor, src_idx: Sequence[int],
                       tau_min: float) -> torch.Tensor:
    """The plain PyTorch version of :func:`octant_trace`: the plane sweep.

    Per shell ``m`` and face (axis ``a``, side ``s``): the plane one step
    nearer the source gives ``c1``; ``c2``, ``c3``, ``c4`` are that plane
    shifted toward the source along the first, the second and both of the
    other two axes (ascending array order).  Only the cells whose major axis
    is ``a`` are written: those with ``m`` at least their offset on a
    lower-preference axis and more than their offset on a higher one
    (x > y > z)."""
    if dtau.ndim != 3:
        raise ValueError(f"dtau must be (nz, ny, nx), got {tuple(dtau.shape)}")
    shape = tuple(dtau.shape)
    src = tuple(int(s) for s in src_idx)
    if not all(0 <= s < n for s, n in zip(src, shape)):
        raise ValueError(f"source cell {src} outside the grid {shape}")
    dev, dtype = dtau.device, dtau.dtype
    col = torch.zeros_like(dtau)
    col[src] = dtau[src]
    toward = [_toward(shape[a], src[a], dev) for a in range(3)]
    off = [torch.abs(torch.arange(shape[a], device=dev) - src[a])
           for a in range(3)]
    n_steps = max(max(src[a], shape[a] - 1 - src[a]) for a in range(3))
    for m in range(1, n_steps + 1):
        corr = 1.0
        if m < 10:
            corr = ((m * m + 0.25) / ((m - 1) ** 2 + 0.25)) ** 0.5 \
                * (m - 1) / max(m, 1)
        for a in range(3):
            p1, p2 = [b for b in range(3) if b != a]
            o1 = off[p1][:, None]
            o2 = off[p2][None, :]
            # x > y > z: a tie goes to the higher axis
            mask = ((o1 < m) if p1 > a else (o1 <= m)) \
                & ((o2 < m) if p2 > a else (o2 <= m))
            d0 = o1.to(dtype) / m
            d1 = o2.to(dtype) / m
            on_axis = (o1 == 0) & (o2 == 0)
            for s in (-1, 1):
                idx = src[a] + s * m
                if not 0 <= idx < shape[a]:
                    continue
                c1 = col.select(a, idx - s)
                c2 = c1.index_select(0, toward[p1])
                c3 = c1.index_select(1, toward[p2])
                c4 = c2.index_select(1, toward[p2])
                w1 = (1.0 - d0) * (1.0 - d1) / torch.clamp(c1, min=tau_min)
                w2 = d0 * (1.0 - d1) / torch.clamp(c2, min=tau_min)
                w3 = (1.0 - d0) * d1 / torch.clamp(c3, min=tau_min)
                w4 = d0 * d1 / torch.clamp(c4, min=tau_min)
                tau_in = (w1 * c1 + w2 * c2 + w3 * c3 + w4 * c4) / (
                    w1 + w2 + w3 + w4)
                tau_in = torch.where(on_axis, c1 * corr, tau_in)
                cur = col.select(a, idx)
                cur.copy_(torch.where(mask, tau_in + dtau.select(a, idx),
                                      cur))
    return col
