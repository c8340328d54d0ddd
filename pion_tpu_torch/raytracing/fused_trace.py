"""Fused point-source trace: wrapper and plain version.

One CUDA kernel (source in ``csrc/trace.cu``) takes the place of the TPU
kernel ``_octant_kernel_3d`` of ``pion_tpu/raytracing/pallas_trace.py`` and
of its host-side wrapper ``OctantSweep3D``: :func:`octant_trace` returns
``col``, the
optical depth from the source to every cell's exit, by the C2Ray
short-characteristics interpolation (Mellema et al. 2006 eq. A5), for a
source in any cell of an ``(nz, ny, nx)`` grid (``nz = 1`` for a 2D grid).

Beside it stands its plain PyTorch version, :func:`octant_trace_plain`: the
same sweep as dense plane operations, Chebyshev shell by shell, the two
z-faces, the two y-faces, then the two x-faces.  The wrapper takes the plain
version only because the tensor it was given lies on the CPU; for a CUDA
tensor it launches the kernel or raises.  The wrapper counts its launches in
its ``launches`` attribute.  What bounds the kernel on an H100 is written at
the head of ``csrc/trace.cu``.
"""
from __future__ import annotations

from typing import Sequence

import torch


def supports(shape: Sequence[int], src_idx: Sequence[int], dtype) -> bool:
    """Whether the kernel covers this trace: a 3D array (a 2D grid as a slab
    one cell deep), the source in a cell of the grid, float32 or float64."""
    return (len(shape) == 3 and len(src_idx) == 3
            and all(n >= 1 for n in shape)
            and all(0 <= s < n for s, n in zip(src_idx, shape))
            and dtype in (torch.float32, torch.float64))


def octant_trace(dtau: torch.Tensor, src_idx: Sequence[int],
                 tau_min: float) -> torch.Tensor:
    """``col`` of one point source: ``dtau`` is the per-cell optical depth
    increment ``(nz, ny, nx)``, ``src_idx`` the source cell, ``tau_min`` the
    floor of the interpolation weights.  ``col - dtau`` is the optical depth
    to each cell's entry.  A CPU tensor takes :func:`octant_trace_plain`; a
    CUDA tensor launches the kernel or raises."""
    if not dtau.is_cuda:
        return octant_trace_plain(dtau, src_idx, tau_min)
    from .. import _build

    src = tuple(int(s) for s in src_idx)
    if not supports(dtau.shape, src, dtau.dtype):
        raise ValueError(
            f"trace of shape {tuple(dtau.shape)} {dtau.dtype} with source "
            f"cell {src} is outside fused_trace.supports()")
    dtau = dtau.contiguous()
    lib = _build.get_trace_lib(
        "float32" if dtau.dtype == torch.float32 else "float64")
    # every cell is written by the octant(s) it belongs to
    col = torch.empty_like(dtau)
    nz, ny, nx = dtau.shape
    err = lib.pion_octant_trace(
        dtau.data_ptr(), col.data_ptr(), nz, ny, nx, *src, float(tau_min),
        torch.cuda.current_stream(dtau.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"octant_trace kernel launch failed: CUDA error {err}")
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
