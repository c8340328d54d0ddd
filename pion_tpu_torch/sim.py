"""Host-side simulation loop (Time_Int).

Equivalent of the reference main loop (reference:
source/sim_control/sim_control.cpp:202-290 Time_Int; dt policy in
source/sim_control/calc_timestep.cpp:68-260).  The per-step device work is one
call into :func:`pion_tpu_torch.stepper.make_step_fns`'s ``step``; everything
here (dt caps, the clock, logging) is cheap host logic, and the only value
read back from the device per step is the pair (dt, dt_raw).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .boundaries import BoundaryData, make_fixed_strips
from .config import SimConfig
from .grid import Geometry, make_geometry
from .stepper import make_step_fns
from .utils import StepLogger, resolve_device

_NO_IO = ("snapshots, checkpoints and restart are not ported yet "
          "(they wait for io/snapshot)")


@dataclasses.dataclass
class Simulation:
    cfg: SimConfig
    P: torch.Tensor
    t: float = 0.0
    step_count: int = 0
    last_dt: float = 0.0
    # output/checkpoint policy (reference: sim_init.cpp:671-760); the fields
    # are kept, setting any of them raises until the snapshot I/O is ported
    outfile: Optional[str] = None
    opfreq: int = 0
    opfreq_time: float = 0.0
    checkpoint_freq: int = 0
    physics: Optional[object] = None   # pion_tpu_torch.physics.Physics
    log_freq: int = 0                  # per-step status line cadence
    # None: the CUDA device (raises if there is none); "cpu" on request
    device: Optional[object] = None

    def __post_init__(self):
        cfg = self.cfg
        if cfg.nlevels > 1:
            raise NotImplementedError("nested grids are not ported yet")
        if cfg.conduction:
            raise NotImplementedError("thermal conduction is not ported yet")
        if cfg.halo == "explicit" or cfg.mesh == "on":
            raise NotImplementedError("multi-device runs are not ported yet")
        if (self.outfile is not None or self.opfreq or self.opfreq_time
                or self.checkpoint_freq):
            raise NotImplementedError(_NO_IO)
        self.device = resolve_device(self.device)
        expect = (cfg.nvar,) + cfg.shape
        if tuple(self.P.shape) != expect:
            raise ValueError(
                f"state shape {tuple(self.P.shape)} != {expect} expected "
                f"from the config (nvar, *shape)")
        # the frozen inflow/fixed strips are taken from the state as given,
        # on the host, before it is cast
        P_host = (self.P.detach().cpu().numpy()
                  if isinstance(self.P, torch.Tensor) else np.asarray(self.P))
        # normalize the state to the config dtype on the run's device (pass
        # numpy float64 arrays to keep full float64 ICs through this cast)
        self.P = torch.as_tensor(P_host).to(
            dtype=cfg.torch_dtype, device=self.device).contiguous()
        self.geom: Geometry = make_geometry(cfg)
        self.bdata: BoundaryData = make_fixed_strips(
            P_host.astype(cfg.np_dtype), cfg)
        if self.physics is not None:
            # raises for what is not ported yet (stellar winds)
            self.physics.setup(cfg, self.geom)
        self.fns = make_step_fns(cfg, self.geom, self.bdata,
                                 physics=self.physics, device=self.device)

    @classmethod
    def restart(cls, path: str, **kw) -> "Simulation":
        raise NotImplementedError(_NO_IO)

    def save(self, path: Optional[str] = None, wait: bool = True) -> str:
        raise NotImplementedError(_NO_IO)

    # -- dt policy (reference: calc_timestep.cpp:219-260) ------------------
    def _dt_cap(self) -> float:
        """Host-side dt ceiling: the end time (reference:
        timestep_checking_and_limiting clamps dt to finishtime-simtime,
        calc_timestep.cpp:243-252)."""
        tmax = getattr(self, "_tmax", None) or self.cfg.tmax
        return tmax - self.t

    def compute_dt(self) -> float:
        dt = float(self.fns.calc_dt(self.P))
        if self.last_dt > 0.0:
            dt = min(dt, self.cfg.max_dt_growth * self.last_dt)
        dt = min(dt, self._dt_cap())
        if dt < self.cfg.min_timestep:
            raise RuntimeError(f"timestep too small: {dt}")
        return dt

    def step(self) -> float:
        sp = (self.physics.update_sources(self.t)
              if self.physics is not None and self.physics.sources else None)
        Pn, dt, dt_raw = self.fns.step(self.P, self.t, self.last_dt,
                                       self._dt_cap(), sp)
        # the step's one read-back from the device
        dt, dt_raw = torch.stack([dt, dt_raw]).tolist()
        if dt_raw < self.cfg.min_timestep:
            raise RuntimeError(f"timestep too small: {dt_raw}")
        self.P = Pn
        self.t += dt
        self.last_dt = dt
        self.step_count += 1
        return dt

    def run(self, tmax: Optional[float] = None, max_steps: int = 10**9,
            callback: Optional[Callable] = None):
        """Advance to ``tmax`` or by ``max_steps`` steps, whichever comes
        first."""
        tmax = self.cfg.tmax if tmax is None else tmax
        self._tmax = tmax
        logger = StepLogger(self.log_freq)
        while self.t < tmax * (1.0 - 1e-12) and self.step_count < max_steps:
            dt = self.step()
            logger.log(self.step_count, self.t, dt, self.P)
            if callback is not None:
                callback(self)
        if self.P.is_cuda:
            torch.cuda.synchronize(self.P.device)
        return self
