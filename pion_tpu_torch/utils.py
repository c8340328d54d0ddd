"""Runtime utilities: device choice, conservation audits, step logging.

Equivalents of the reference utility layer (reference: sim_control.cpp:401-450
conservation checks; sim_control.cpp:240-270 per-step status line).
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from .config import SimConfig
from .constants import PG, RO, VX, VY, VZ
from .grid import Geometry
from .ops.eqns import prim_to_cons


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another.  There is no silent CPU run: with ``device=None`` and no
    CUDA device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def conservation_totals(P, cfg: SimConfig, geom: Geometry) -> Dict[str, float]:
    """Volume-integrated mass/energy/momentum (reference:
    sim_control.cpp:401-450 initial/final energy audit).  Summed on the
    host in float64."""
    U = prim_to_cons(torch.as_tensor(P), cfg).detach().cpu().double().numpy()
    vol = geom.cell_volume
    out = {
        "mass": float((U[RO] * vol).sum()),
        "energy": float((U[PG] * vol).sum()),
        "mom_x": float((U[VX] * vol).sum()),
    }
    if cfg.ndim > 1:
        out["mom_y"] = float((U[VY] * vol).sum())
    if cfg.ndim > 2:
        out["mom_z"] = float((U[VZ] * vol).sum())
    return out


class StepLogger:
    """Per-step status line for the run loop (reference:
    sim_control.cpp:240-270 prints dt/simtime/walltime each step, plus the
    TESTING finite-ness checks of time_integrator.cpp:745-750).  ``freq=0``
    disables logging; at log cadence a cheap device reduce flags a
    non-finite state instead of silently running to the end."""

    def __init__(self, freq: int = 0):
        self.freq = int(freq)
        self.t0 = time.time()

    def log(self, step: int, t: float, dt: float, P=None):
        if not self.freq or step % self.freq:
            return
        line = (f"New time: {t:.6e}   dt: {dt:.6e}   steps: {step}"
                f"   walltime: {time.time() - self.t0:.1f}s")
        if P is not None and not bool(torch.isfinite(P).all()):
            line += "   *** NON-FINITE STATE ***"
        print(line, flush=True)
