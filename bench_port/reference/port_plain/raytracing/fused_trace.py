"""The point-source trace as plain PyTorch: :func:`octant_trace_plain`
returns ``col``, the optical depth from the source to every cell's exit, by
the C2Ray short-characteristics interpolation (Mellema et al. 2006 eq. A5),
for a source in any cell of an ``(nz, ny, nx)`` grid (``nz = 1`` for a 2D
grid): dense plane operations, Chebyshev shell by shell, the two z-faces,
the two y-faces, then the two x-faces.  The program's CUDA kernels and
their launch plan are left out of this copy."""
from __future__ import annotations

from typing import Sequence

import torch


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
