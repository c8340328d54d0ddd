"""Snapshot comparison — the regression oracle.

Counterpart of the JAX package's ``pion_tpu/io/compare.py``, the equivalent
of the reference's ``silocompare`` tool
(reference: analysis/silocompare/silocompare.cpp:78,259-282): cell-by-cell
diff of two snapshots with L1/L2/max norms per variable, used to gate
serial-vs-parallel equivalence, restart equivalence, and solver
regressions.  The norms are taken on the host in numpy (the JAX package's
optional C++ inner loop is not ported: without it the JAX package takes the
same numpy).  Run as ``python -m pion_tpu_torch.io.compare A B
[--absolute]``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .snapshot import load_snapshot

VAR_NAMES = ["rho", "pg", "vx", "vy", "vz", "bx", "by", "bz", "psi"]


def _host(A) -> np.ndarray:
    if isinstance(A, torch.Tensor):
        return A.detach().cpu().numpy()
    return np.asarray(A)


def compare_states(A, B, relative: bool = True) -> Dict:
    """Per-variable L1/L2/max norms of (A-B); relative norms divide by the
    mean |A| of that variable (matching silocompare's rel mode).  ``A`` and
    ``B`` are numpy arrays or torch tensors on any device."""
    A = _host(A)
    B = _host(B)
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    out = {}
    for v in range(A.shape[0]):
        scale = np.mean(np.abs(A[v])) if relative else 1.0
        scale = scale if scale > 0 else 1.0
        name = (VAR_NAMES[v] if v < len(VAR_NAMES)
                else f"tr{v - len(VAR_NAMES)}")
        d = A[v] - B[v]
        l1 = np.mean(np.abs(d))
        l2 = np.sqrt(np.mean(d * d))
        mx = np.max(np.abs(d))
        out[name] = {
            "L1": float(l1 / scale),
            "L2": float(l2 / scale),
            "max": float(mx / scale),
        }
    out["all_L1"] = max(m["L1"] for m in out.values() if isinstance(m, dict))
    out["all_max"] = max(m["max"] for m in out.values() if isinstance(m, dict))
    return out


def compare_snapshots(path1: str, path2: str, relative: bool = True) -> Dict:
    cfg1, P1, t1, _ = load_snapshot(path1)
    cfg2, P2, t2, _ = load_snapshot(path2)
    res = compare_states(P1, P2, relative=relative)
    res["dt_sim"] = abs(t1 - t2)
    return res


def main():  # pragma: no cover - CLI
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="snapshot diff (silocompare equivalent)")
    ap.add_argument("file1")
    ap.add_argument("file2")
    ap.add_argument("--absolute", action="store_true")
    args = ap.parse_args()
    print(json.dumps(compare_snapshots(args.file1, args.file2,
                                       relative=not args.absolute), indent=2))


if __name__ == "__main__":  # pragma: no cover
    main()
