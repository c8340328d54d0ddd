"""Time integration: OA1 / OA2 predictor-corrector updates.

Counterpart of the reference time integrator
(reference: source/sim_control/time_integrator.cpp:70-243 ``advance_time``,
``first_order_update``, ``second_order_update``, and :881-960
``grid_update_state_vector``).  The reference's two per-cell state vectors
``P`` (start-of-step) and ``Ph`` (half-step) become two dense tensors; no
function here writes into the state it is given.

Scheme (OA2): Ph = P + (dt/2)*dU[Ph, 1st-order space];
              P' = P + dt*dU[Ph, 2nd-order space].

``dt`` and the GLM cleaning speed ``ch`` stay on the device as 0-d tensors
from the CFL reduction to the last kernel of the step; nothing in this module
reads them back.

``multi_step`` runs K steps with the dt policy on the device (the clock
``t`` and ``last_dt`` as float64 0-d tensors): on a CUDA state with the
kernels on, as one replay of a CUDA graph (:mod:`.graphs`); otherwise
eagerly, step after step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .boundaries import BoundaryData, apply_bcs
from .config import SimConfig
from .constants import SI, Eqn
from .grid import Geometry
from .ops import fused_sweep
from .ops.eqns import cons_to_prim, prim_to_cons
from .ops.sweep import dynamics_dU
from .ops.timestep import dynamics_dt
from .utils import resolve_device


def later(t, dt):
    """``t + dt`` as the per-step path forms it.  There ``t`` is a host
    number and ``dt`` a 0-d tensor, and the sum is a tensor of ``dt``'s
    dtype (the number rounded to it first); a tensor ``t`` (float64, the
    clock of a chunk) is rounded the same way, so that a chunk passes the
    same instant to a time-dependent boundary as the step does."""
    if isinstance(t, torch.Tensor) and isinstance(dt, torch.Tensor):
        return t.to(dt.dtype) + dt
    return t + dt


def limit_dt(dt, last_dt, cap, growth: float):
    """The growth limit, then the cap (reference: calc_timestep.cpp:219-260
    timestep_checking_and_limiting).  Host numbers ``last_dt`` and ``cap``
    are rounded to ``dt``'s dtype by ``torch.clamp``; float64 0-d tensors
    (the clock of a chunk) are rounded the same way, so both give the same
    ``dt`` bit for bit."""
    if isinstance(last_dt, torch.Tensor):
        grown = (growth * last_dt).to(dt.dtype)
        dt = torch.where(last_dt > 0.0, torch.minimum(dt, grown), dt)
        return torch.minimum(dt, cap.to(dt.dtype))
    if last_dt > 0.0:
        dt = torch.clamp(dt, max=growth * last_dt)
    return torch.clamp(dt, max=cap)


def cell_advance(P, dU, cfg: SimConfig):
    """U(P) + dU -> primitive, with floor recovery inside cons_to_prim
    (reference: solver_eqn_hydro_adi.cpp:372-448 CellAdvanceTime)."""
    U = prim_to_cons(P, cfg) + dU
    return cons_to_prim(U, cfg)


def glm_psi_damp(P, dt, ch, cfg: SimConfig, geom: Geometry):
    """Parabolic damping psi *= exp(-dt*c_h*c_r), c_r = 0.25/dx
    (reference: eqns_mhd_adiabatic.cpp:651-660 GLMsource;
    calc_timestep.cpp:128-137 sets cr).  Returns a new tensor."""
    cr = cfg.glm_cr_factor / geom.dx
    damp = torch.exp(torch.as_tensor(-dt * ch * cr, dtype=P.dtype,
                                     device=P.device))
    return torch.cat([P[:SI], (P[SI] * damp)[None], P[SI + 1:]])


def _scma_flag(physics):
    """sCMA sweep flag: element-slot tuple when the module declares
    element tracers, plain True when a module owns the tracers at all."""
    if physics is None or physics.mp is None:
        return False
    el = tuple(getattr(physics.mp, "element_slots", ()) or ())
    return el if el else True


def _partial_update(P, Ph, dt, order_space, cfg, geom, bdata, ch,
                    physics=None, t=0.0, rt=None, sp=None):
    """One flux update: dU from Ph, applied on top of P.

    Chemistry contributes a conserved increment computed from P with columns
    traced through Ph (reference: time_integrator.cpp:151-197, 206-243 —
    RT_all_sources -> calc_microphysics_dU -> calc_dynamics_dU).
    Returns the advanced primitive state as a new tensor (the OA2
    corrector reads the old ``P`` again, so ``P`` is never written)."""
    if cfg.conduction:
        raise NotImplementedError("thermal conduction is not ported yet")
    Ppad = apply_bcs(Ph, cfg, bdata, t=t)
    dU = None
    if cfg.kernels != "off" and fused_sweep.supports(cfg):
        # The wrappers launch the CUDA kernels for a CUDA tensor and take
        # their plain versions for a CPU tensor.
        if physics is None:
            # pure dynamics: the final-axis kernel also applies the
            # conserved update + floors + GLM damping (no separate passes)
            return fused_sweep.advance_dynamics(P, Ppad, cfg, geom, dt,
                                                order_space, ch=ch)
        dU = fused_sweep.dynamics_dU_fused(Ppad, cfg, geom, dt, order_space,
                                           ch=ch, scma=_scma_flag(physics))
    if dU is None:
        dU, _faces = dynamics_dU(Ppad, cfg, geom, dt, order_space, ch=ch,
                                 scma=(physics is not None
                                       and physics.mp is not None))
    if physics is not None and physics.mp is not None:
        dU = dU + physics.mp_delta_U(P, Ph, dt, cfg, rt=rt, sp=sp)
    Pnew = cell_advance(P, dU, cfg)
    if cfg.eqn is Eqn.GLM:
        Pnew = glm_psi_damp(Pnew, dt, ch, cfg, geom)
    if physics is not None:
        if physics.mp is not None:
            # temperature clamps (reference: grid_update_state_vector:914-920)
            T = physics.mp.temperature(Pnew, cfg)
            Pnew = torch.where(
                T > cfg.max_temperature,
                physics.mp.set_temp(Pnew, cfg.max_temperature, cfg), Pnew)
        Pnew = physics.apply_internal_bcs(Pnew, later(t, dt))
    return Pnew


def advance(P, dt, cfg: SimConfig, geom: Geometry,
            bdata: Optional[BoundaryData] = None, ch=None, physics=None,
            t=0.0, rt0=None, sp=None):
    """Advance one full step of size dt; returns the new state.

    OA1: single 1st-order update (reference: time_integrator.cpp:80-97).
    OA2: half-step predictor (1st-order space) then full corrector
    (2nd-order space) (reference: time_integrator.cpp:99-124).
    ``dt`` may be a number or a 0-d tensor on the state's device.
    ``rt0``: radiation columns already traced through P (the predictor's
    Ph), e.g. shared with the dt computation in the fused step.
    """
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    if cfg.ooa == 1:
        return _partial_update(P, P, dt, 1, cfg, geom, bdata, ch, physics, t,
                               rt=rt0, sp=sp)
    Ph = _partial_update(P, P, 0.5 * dt, 1, cfg, geom, bdata, ch, physics, t,
                         rt=rt0, sp=sp)
    return _partial_update(P, Ph, dt, 2, cfg, geom, bdata, ch, physics, t,
                           sp=sp)


class StepFns(NamedTuple):
    advance: callable   # (P, dt, t=0.0, sp=None) -> P_new
    calc_dt: callable   # (P,) -> 0-d tensor, dt before the growth limit
    step: callable      # (P, t, last_dt, dt_cap, sp=None) -> (P_new, dt, dt_raw)
    # (P, t, last_dt, t_target, sp=None, K=16) -> (P_new, info (3, K)):
    # K steps in one dispatch, the rows of info dt, dt_raw and live
    multi_step: callable = None


def make_step_fns(cfg: SimConfig, geom: Geometry,
                  bdata: Optional[BoundaryData] = None,
                  physics=None, device=None) -> StepFns:
    """Build the advance/dt functions with the config closed over.

    The functions put the state they are given on ``device``: the CUDA
    device when ``device`` is None (raising if there is none), the CPU only
    when the caller asks for it."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype

    def _state(P):
        return torch.as_tensor(P, dtype=dtype, device=dev)

    def _dt_expr(P, rt0=None):
        excl = (physics.wind_exclude_mask(P)
                if physics is not None and physics.winds else None)
        dt = dynamics_dt(P, cfg, geom, exclude=excl)
        if physics is not None and physics.dt_limit and physics.mp is not None:
            # chemistry/cooling dt limit (reference: calc_timestep.cpp:342
            # calc_microphysics_dt with MP_timestep_limit)
            dt = torch.minimum(dt, physics.timescale(P, cfg, rt=rt0))
        return dt

    def _advance(P, dt, t=0.0, sp=None):
        return advance(_state(P), dt, cfg, geom, bdata, physics=physics,
                       t=t, sp=sp)

    def _calc_dt(P):
        return _dt_expr(_state(P))

    def _dt_of(P, sp):
        rt0 = None
        if (physics is not None and physics.sources
                and physics.mp is not None):
            rt0 = physics.raytrace(P, sp=sp)
        return _dt_expr(P, rt0), rt0

    def _step(P, t, last_dt, dt_cap, sp=None):
        """Fused dt + advance.  The radiation columns through P are traced
        ONCE and shared between the chemistry dt limit and the predictor
        partial update (the reference also raytraces once per partial
        update, not once per consumer — time_integrator.cpp:206-243).  dt
        clamps follow the reference's timestep_checking_and_limiting
        (calc_timestep.cpp:219-260): growth limit, then the caller-supplied
        cap (next output time / finish time).  ``last_dt`` and ``dt_cap``
        are host numbers; ``dt`` and ``dt_raw`` come back as 0-d tensors on
        the device, unread."""
        P = _state(P)
        dt_raw, rt0 = _dt_of(P, sp)
        dt = limit_dt(dt_raw, last_dt, dt_cap, cfg.max_dt_growth)
        Pn = advance(P, dt, cfg, geom, bdata, physics=physics, t=t, rt0=rt0,
                     sp=sp)
        return Pn, dt, dt_raw

    def _chunk(P, t, last_dt, t_stop, t_target, sp, K):
        """K steps of :func:`_step` on the device.  ``t``, ``last_dt``,
        ``t_stop`` and ``t_target`` are float64 0-d tensors.  A step is live
        while ``t < t_stop`` (the host loop's test); each applies the growth
        limit and the cap ``t_target - t``; a step that is not live advances
        by dt = 1 and is dropped, so the state passes through (the body of
        the JAX package's ``multi_step``, stepper.py:228-252).  Returns the
        state and ``(3, K)`` float64: dt (0 where not live), dt_raw, live."""
        rows = []
        for _ in range(K):
            dt_raw, rt0 = _dt_of(P, sp)
            dt = limit_dt(dt_raw, last_dt, t_target - t, cfg.max_dt_growth)
            live = t < t_stop
            Pn = advance(P, torch.where(live, dt, 1.0), cfg, geom, bdata,
                         physics=physics, t=t, rt0=rt0, sp=sp)
            P = torch.where(live, Pn, P)
            dt64 = dt.to(torch.float64)
            dt_eff = torch.where(live, dt64, 0.0)
            t = t + dt_eff
            last_dt = torch.where(live, dt64, last_dt)
            rows.append(torch.stack([dt_eff, dt_raw.to(torch.float64),
                                     live.to(torch.float64)]))
        return P, torch.stack(rows, dim=1)

    def _multi_step(P, t, last_dt, t_target, sp=None, K=16):
        """K steps in one dispatch (the JAX package's ``multi_step``, a
        ``lax.scan``).  ``t``, ``last_dt`` and ``t_target`` are host
        numbers; ``sp`` is taken once for the K steps.  Returns the state
        and ``(3, K)`` float64 on the state's device: the dt of each step (0
        once ``t`` has reached ``t_target``), its dt before the limits, and
        whether it was live.  On a CUDA state with the kernels on, the K
        steps are one replay of a CUDA graph, captured at the first call for
        each K and ``sp`` layout (and raising if the capture fails);
        with ``kernels="off"``, whose plain chemistry reads the host, and on
        the CPU they run eagerly, step after step."""
        from . import graphs

        P = _state(P)
        spt = physics.device_sp(sp, P) if physics is not None else None
        clock = graphs.clock(P.device, t, last_dt, t_target)
        if P.is_cuda and cfg.kernels != "off":
            key = (K, graphs.layout(spt))
            if key not in recorded:
                recorded[key] = graphs.ChunkGraph(
                    lambda P_, c, s: _chunk(P_, *c, s, K),
                    (P, clock, spt), name=f"step x{K}")
            return recorded[key]((P, clock, spt))
        return _chunk(P, *clock, spt, K)

    # the graphs by K and sources' layout; the function does not refer to
    # itself, so that a run's graphs go with it and not with a later
    # collection of reference cycles (which might fall inside a capture)
    recorded: dict = {}
    _multi_step.graphs = recorded

    return StepFns(advance=_advance, calc_dt=_calc_dt, step=_step,
                   multi_step=_multi_step)
