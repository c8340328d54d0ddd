"""Host-side simulation loop (Time_Int).

Equivalent of the reference main loop (reference:
source/sim_control/sim_control.cpp:202-290 Time_Int; dt policy in
source/sim_control/calc_timestep.cpp:68-260).  The per-step device work is one
call into :func:`pion_tpu_torch.stepper.make_step_fns`'s ``step``; everything
here (dt caps, the clock, output cadence, logging) is cheap host logic, and
the only value read back from the device per step is the pair (dt, dt_raw).
``run(chunk=k)`` takes k steps at a time through ``multi_step`` (one CUDA
graph replay on the card) and reads back once a chunk.  A nested-grid run is
driven by :class:`pion_tpu_torch.ng.NGHierarchy`, not from here.
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

_NO_PARAMS = ("rebuilding the physics of a restart from the snapshot's "
              "parameter section needs cli.physics_from_params, which is not "
              "ported yet (ROADMAP.md, queue A item 17); pass physics=")


@dataclasses.dataclass
class Simulation:
    cfg: SimConfig
    P: torch.Tensor
    t: float = 0.0
    step_count: int = 0
    last_dt: float = 0.0
    # output/checkpoint policy (reference: sim_init.cpp:671-760 output_data,
    # :681-700 rolling checkpoints alternating two files)
    outfile: Optional[str] = None
    opfreq: int = 0              # snapshot every N steps (0 = only final)
    opfreq_time: float = 0.0     # snapshot every dt_sim (OutputCriterion 1,
    #                              reference: sim_init.cpp:695-760 OPfreqTime)
    checkpoint_freq: int = 0     # rolling checkpoint every N steps
    physics: Optional[object] = None   # pion_tpu_torch.physics.Physics
    # raw parameter dict persisted into snapshot headers (reference: the
    # RT_*/WIND_*/EP_* registry in every header, dataIO/parameter_defs.h:56);
    # carried through save and restart, not interpreted here
    params: Optional[dict] = None
    log_freq: int = 0                  # per-step status line cadence
    # None: the CUDA device (raises if there is none); "cpu" on request
    device: Optional[object] = None

    def __post_init__(self):
        cfg = self.cfg
        if cfg.nlevels > 1:
            raise NotImplementedError(
                "Simulation advances one grid; a nested-grid run "
                f"(nlevels={cfg.nlevels}) goes through "
                "pion_tpu_torch.ng.NGHierarchy")
        if cfg.conduction:
            raise NotImplementedError("thermal conduction is not ported yet")
        if cfg.halo == "explicit" or cfg.mesh == "on":
            raise NotImplementedError("multi-device runs are not ported yet")
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
            self.physics.setup(cfg, self.geom)
            # carve wind regions into the initial state (reference:
            # assign_boundary_data for STWIND at setup)
            if self.physics.winds:
                self.P = self.physics.apply_internal_bcs(self.P, self.t)
        self.fns = make_step_fns(cfg, self.geom, self.bdata,
                                 physics=self.physics, device=self.device)
        self._ckpt_flip = 0
        self._writer = None  # lazy AsyncSnapshotWriter
        self._next_optime = self.t + self.opfreq_time

    @classmethod
    def restart(cls, path: str, **kw) -> "Simulation":
        """Resume from any snapshot (reference: main.cpp:99-112 restart
        detection; every snapshot is a full restart file).  The caller
        passes the run's ``physics``; rebuilding it from a parameter section
        in the header is not ported."""
        from .io.snapshot import load_snapshot_raw

        cfg, P, t, step, extra = load_snapshot_raw(path)
        params = (extra or {}).get("params")
        if params:
            if "physics" not in kw:
                raise NotImplementedError(_NO_PARAMS)
            kw.setdefault("params", params)
        return cls(cfg, P, t=t, step_count=step, **kw)

    def save(self, path: Optional[str] = None, wait: bool = True) -> str:
        """Write a snapshot; with ``wait=False`` it is queued on the
        background writer thread and the step loop continues immediately
        (the PMPIO-overlap equivalent)."""
        if path is None:
            if not self.outfile:
                raise ValueError("set Simulation.outfile or pass a path")
            path = f"{self.outfile}.{self.step_count:08d}"
        extra = {"params": self.params} if self.params else None
        if wait:
            from .io import save_snapshot

            self.flush_io()
            return save_snapshot(path, self.P, self.cfg, self.t,
                                 self.step_count, extra=extra)
        if self._writer is None:
            from .io.snapshot import AsyncSnapshotWriter

            self._writer = AsyncSnapshotWriter()
        self._writer.submit(path, self.P, self.cfg, self.t, self.step_count,
                            extra)
        return path

    def flush_io(self):
        """Block until queued async snapshots are on disk."""
        if self._writer is not None:
            self._writer.wait()

    def _maybe_output(self):
        if self.outfile is None:
            return
        if self.opfreq and self.step_count % self.opfreq == 0:
            self.save(wait=False)
        # tolerance catches exact-landing steps that round a ulp short
        tol = 1.0e-12 * max(abs(self._next_optime), self.opfreq_time)
        if self.opfreq_time > 0.0 and self.t >= self._next_optime - tol:
            while self._next_optime - tol <= self.t:
                self._next_optime += self.opfreq_time
            self.save(wait=False)
        if self.checkpoint_freq and self.step_count % self.checkpoint_freq == 0:
            # alternate two files like the reference's .999999/.999998
            suffix = 999999 - self._ckpt_flip
            self._ckpt_flip ^= 1
            self.save(f"{self.outfile}.{suffix}", wait=False)

    # -- dt policy (reference: calc_timestep.cpp:219-260) ------------------
    def _dt_cap(self) -> float:
        """Host-side dt ceiling: end time and the next timed-output instant
        (reference: timestep_checking_and_limiting clamps dt to
        next_optime-simtime then finishtime-simtime, calc_timestep.cpp:243-252
        — so opfreq_time snapshots land exactly on cadence)."""
        tmax = getattr(self, "_tmax", None) or self.cfg.tmax
        cap = tmax - self.t
        # first-step wind-speed ceiling (reference: calc_dynamics_dt caps
        # dt <= 0.1 CFL dx / Vinf on timestep 0, since wind cells are
        # excluded from the CFL reduction)
        if (self.step_count == 0 and self.physics is not None
                and self.physics.wind_sources):
            cap = min(cap, self.physics.wind_dt_cap(self.cfg, self.geom))
        if self.opfreq_time > 0.0 and self.outfile is not None:
            to_next = self._next_optime - self.t
            # fp guard: if we are within rounding of the output instant,
            # aim for the one after rather than taking a ~0 step
            tol = 1.0e-12 * max(abs(self._next_optime), self.opfreq_time)
            if to_next <= tol:
                to_next += self.opfreq_time
            cap = min(cap, to_next)
        return cap

    def compute_dt(self) -> float:
        dt = float(self.fns.calc_dt(self.P))
        if self.last_dt > 0.0:
            dt = min(dt, self.cfg.max_dt_growth * self.last_dt)
        dt = min(dt, self._dt_cap())
        if dt < self.cfg.min_timestep:
            raise RuntimeError(f"timestep too small: {dt}")
        return dt

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

    def _chunk(self, chunk: int, tmax: float) -> Optional[float]:
        """``chunk`` steps through ``multi_step``, the evolving sources
        taken once for all of them (as the JAX package does); the clock
        advances by each live step's dt in turn, as ``step`` advances it.
        Returns the last dt, or None when no step was live."""
        Pn, info = self.fns.multi_step(self.P, self.t, self.last_dt, tmax,
                                       self._sources(), K=chunk)
        dts, raws, live = info.tolist()     # the chunk's one read-back
        n = int(sum(live))
        if n and min(raws[:n]) < self.cfg.min_timestep:
            raise RuntimeError(f"timestep too small: {min(raws[:n])}")
        if n == 0:
            return None
        self.P = Pn
        for dt in dts[:n]:
            self.t += dt
        self.last_dt = dts[n - 1]
        self.step_count += n
        return self.last_dt

    def run(self, tmax: Optional[float] = None, max_steps: int = 10**9,
            callback: Optional[Callable] = None, chunk: int = 1):
        """Advance to ``tmax`` or by ``max_steps`` steps, whichever comes
        first.

        ``chunk`` > 1 takes that many steps at a time in one dispatch when
        nothing has to run on the host between them: no timed output, no
        callback, and output, checkpoint and log cadences that are multiples
        of the chunk (the JAX package's gate, sim.py:255-262).  On a CUDA
        state with the kernels on,
        one replay of a CUDA graph recorded at the first chunk (raising if
        the recording fails); with ``kernels="off"`` and on the CPU, the
        same steps eagerly.  A chunk ends early at ``tmax``; ``max_steps``
        is never passed (the steps short of a whole chunk go one by one); a
        run with winds takes its first step alone, for the first-step wind
        cap.  The result equals the run without ``chunk`` bit for bit, but
        that evolving sources are taken once a chunk."""
        tmax = self.cfg.tmax if tmax is None else tmax
        self._tmax = tmax
        logger = StepLogger(self.log_freq)
        chunked = (chunk > 1 and self.opfreq_time == 0.0 and callback is None
                   and self.opfreq % chunk == 0
                   and self.checkpoint_freq % chunk == 0
                   and (self.log_freq == 0 or self.log_freq % chunk == 0))
        while self.t < tmax * (1.0 - 1e-12) and self.step_count < max_steps:
            if (chunked and self.step_count + chunk <= max_steps
                    and not (self.step_count == 0
                             and self.physics is not None
                             and self.physics.wind_sources)):
                dt = self._chunk(chunk, tmax)
                if dt is None:
                    break
            else:
                dt = self.step()
            self._maybe_output()
            logger.log(self.step_count, self.t, dt, self.P)
            if callback is not None:
                callback(self)
        if self.P.is_cuda:
            torch.cuda.synchronize(self.P.device)
        if self.outfile is not None:
            self.save()
        self.flush_io()
        return self
