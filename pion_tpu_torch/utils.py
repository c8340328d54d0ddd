"""Runtime utilities: device choice, named timers, conservation audits,
walltime guard, step logging, precision check.

Equivalents of the reference tool layer (reference: source/tools/timer.h:27-61
``class timers``; sim_control.cpp:401-450 conservation checks;
sim_control_MPI.cpp:425-440 max-walltime graceful stop;
sim_control.cpp:240-270 per-step status line).
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


class Timers:
    """Named wall-clock timers with start/pause/stop semantics
    (reference: tools/timer.h — used e.g. to split RT waiting vs working),
    each with the number of intervals it has timed (``calls``).  The port's
    user is :mod:`.tracing`, which keeps its spans' host seconds in one.

    They read the host clock.  Work queued on the card runs after the call
    that queued it returns, so synchronise the device
    (``torch.cuda.synchronize()``) before ``pause``/``stop`` when the timed
    region queues device work, or the timer measures the enqueue only."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._started: Dict[str, float] = {}
        self._calls: Dict[str, int] = {}

    def start(self, name: str):
        self._started[name] = time.perf_counter()

    def pause(self, name: str) -> float:
        t0 = self._started.pop(name, None)
        if t0 is not None:
            self._acc[name] = (self._acc.get(name, 0.0)
                               + time.perf_counter() - t0)
            self._calls[name] = self._calls.get(name, 0) + 1
        return self._acc.get(name, 0.0)

    def calls(self, name: str) -> int:
        """The intervals ``name`` has timed (a start and a pause each)."""
        return self._calls.get(name, 0)

    def stop(self, name: str) -> float:
        return self.pause(name)

    def read(self, name: str) -> float:
        run = 0.0
        if name in self._started:
            run = time.perf_counter() - self._started[name]
        return self._acc.get(name, 0.0) + run

    def report(self) -> Dict[str, float]:
        return {k: self.read(k) for k in
                set(self._acc) | set(self._started)}


class WalltimeGuard:
    """Callback for ``Simulation.run``: stop cleanly before a walltime limit
    (reference: sim_control_MPI.cpp:425-440 allreduced walltime check), on
    the host clock; a step's device work has finished when the callback runs
    (the step reads its dt back).

    Past the deadline it sets the run's end time to the current time.  The
    port's run loop reads that end time at every step and stops; the JAX
    package's loop keeps its own copy, and only its dt cap reads the new
    one, so there the steps go on with dt = 0 (a reference behaviour,
    ROADMAP C3)."""

    def __init__(self, max_seconds: float, margin: float = 0.05):
        self.deadline = time.time() + max_seconds * (1.0 - margin)
        self.triggered = False

    def __call__(self, sim):
        if time.time() >= self.deadline:
            self.triggered = True
            sim._tmax = sim.t


def ensure_precision(cfg) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``, raising for anything but float32
    and float64.

    The JAX package's function of this name turns on JAX's process-wide x64
    switch for a float64 config, without which JAX computes in float32.
    Torch has no such switch: each tensor carries its dtype, and the port
    casts a run's state to the config's dtype when the run is built.  So
    here there is nothing to turn on, only the dtype to check."""
    dtype = getattr(cfg, "dtype", None)
    if dtype == "float32":
        return torch.float32
    if dtype == "float64":
        return torch.float64
    raise ValueError(f"dtype must be 'float32' or 'float64', got {dtype!r}")


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
        finite = (P is None or (P.all_finite() if hasattr(P, "all_finite")
                                else bool(torch.isfinite(P).all())))
        if not finite:
            line += "   *** NON-FINITE STATE ***"
        # a state sharded over several processes: the check is theirs
        # together, the line rank 0's
        if getattr(getattr(P, "mesh", None), "rank", 0) == 0:
            print(line, flush=True)
