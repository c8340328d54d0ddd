"""Host-side simulation loop (Time_Int), one step at a time.

Equivalent of the reference main loop (reference:
source/sim_control/sim_control.cpp:202-290 Time_Int; dt policy in
source/sim_control/calc_timestep.cpp:68-260).  The per-step device work is one
call into :func:`.stepper.make_step_fns`'s ``step``; the dt caps and the clock
are host logic, and the only value read back from the device per step is the
pair (dt, dt_raw).  The program's chunks, meshes, snapshots and restarts are
left out of this copy.  A nested-grid run is driven by :class:`.ng.NGHierarchy`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .boundaries import BoundaryData, make_fixed_strips
from .config import SimConfig
from .grid import Geometry, make_geometry
from .stepper import make_step_fns
from .utils import resolve_device


@dataclasses.dataclass
class Simulation:
    cfg: SimConfig
    P: torch.Tensor
    t: float = 0.0
    step_count: int = 0
    last_dt: float = 0.0
    physics: Optional[object] = None   # .physics.Physics
    # None: the CUDA device (raises if there is none); "cpu" on request
    device: Optional[object] = None

    def __post_init__(self):
        cfg = self.cfg
        if cfg.nlevels > 1:
            raise NotImplementedError(
                "Simulation advances one grid; a nested-grid run "
                f"(nlevels={cfg.nlevels}) goes through ng.NGHierarchy")
        expect = (cfg.nvar,) + cfg.shape
        if tuple(self.P.shape) != expect:
            raise ValueError(
                f"state shape {tuple(self.P.shape)} != {expect} expected "
                f"from the config (nvar, *shape)")
        self.device = resolve_device(self.device)
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
            self.physics.setup(cfg, self.geom)
            # carve wind regions into the initial state (reference:
            # assign_boundary_data for STWIND at setup)
            if self.physics.winds:
                self.P = self.physics.apply_internal_bcs(self.P, self.t)
        self.fns = make_step_fns(cfg, self.geom, self.bdata,
                                 physics=self.physics, device=self.device)

    # -- dt policy (reference: calc_timestep.cpp:219-260) ------------------
    def _dt_cap(self) -> float:
        """Host-side dt ceiling: the end time (reference:
        timestep_checking_and_limiting, calc_timestep.cpp:243-252)."""
        tmax = getattr(self, "_tmax", None) or self.cfg.tmax
        cap = tmax - self.t
        # first-step wind-speed ceiling (reference: calc_dynamics_dt caps
        # dt <= 0.1 CFL dx / Vinf on timestep 0, since wind cells are
        # excluded from the CFL reduction)
        if (self.step_count == 0 and self.physics is not None
                and self.physics.wind_sources):
            cap = min(cap, self.physics.wind_dt_cap(self.cfg, self.geom))
        return cap

    def _sources(self):
        """The evolving sources' parameters at ``t`` on the run's device
        (``Physics.update_sources``, then ``device_sp``), or None."""
        if self.physics is None or not self.physics.sources:
            return None
        return self.physics.device_sp(self.physics.update_sources(self.t),
                                      self.P)

    def step(self) -> float:
        Pn, dt, dt_raw = self.fns.step(self.P, self.t, self.last_dt,
                                       self._dt_cap(), self._sources())
        # the step's one read-back from the device
        dt, dt_raw = torch.stack([dt, dt_raw]).tolist()
        if dt_raw < self.cfg.min_timestep:
            raise RuntimeError(f"timestep too small: {dt_raw}")
        self.P = Pn
        self.t += dt
        self.last_dt = dt
        self.step_count += 1
        return dt

    def run(self, tmax: Optional[float] = None, max_steps: int = 10**9):
        """Advance to ``tmax`` or by ``max_steps`` steps, whichever comes
        first, one step at a time."""
        tmax = self.cfg.tmax if tmax is None else tmax
        self._tmax = tmax
        while (self.t < self._tmax * (1.0 - 1e-12)
               and self.step_count < max_steps):
            self.step()
        if self.P.is_cuda:
            torch.cuda.synchronize(self.P.device)
        return self
