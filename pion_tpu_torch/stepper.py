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


def _check_physics(physics):
    if physics is not None:
        raise NotImplementedError(
            "microphysics, radiation and winds are not ported yet: "
            "physics must be None")


def _partial_update(P, Ph, dt, order_space, cfg, geom, bdata, ch,
                    physics=None, t=0.0):
    """One flux update: dU from Ph, applied on top of P.

    Returns the advanced primitive state as a new tensor (the OA2
    corrector reads the old ``P`` again, so ``P`` is never written)."""
    _check_physics(physics)
    if cfg.conduction:
        raise NotImplementedError("thermal conduction is not ported yet")
    Ppad = apply_bcs(Ph, cfg, bdata, t=t)
    if cfg.kernels != "off" and fused_sweep.supports(cfg):
        # pure dynamics: the final-axis kernel also applies the conserved
        # update + floors + GLM damping (no separate passes).  The wrappers
        # launch the CUDA kernels for a CUDA tensor and take their plain
        # versions for a CPU tensor.
        return fused_sweep.advance_dynamics(P, Ppad, cfg, geom, dt,
                                            order_space, ch=ch)
    dU, _faces = dynamics_dU(Ppad, cfg, geom, dt, order_space, ch=ch)
    Pnew = cell_advance(P, dU, cfg)
    if cfg.eqn is Eqn.GLM:
        Pnew = glm_psi_damp(Pnew, dt, ch, cfg, geom)
    return Pnew


def advance(P, dt, cfg: SimConfig, geom: Geometry,
            bdata: Optional[BoundaryData] = None, ch=None, physics=None,
            t=0.0):
    """Advance one full step of size dt; returns the new state.

    OA1: single 1st-order update (reference: time_integrator.cpp:80-97).
    OA2: half-step predictor (1st-order space) then full corrector
    (2nd-order space) (reference: time_integrator.cpp:99-124).
    ``dt`` may be a number or a 0-d tensor on the state's device.
    """
    if cfg.eqn is Eqn.GLM and ch is None:
        ch = cfg.cfl * geom.dx / dt
    if cfg.ooa == 1:
        return _partial_update(P, P, dt, 1, cfg, geom, bdata, ch, physics, t)
    Ph = _partial_update(P, P, 0.5 * dt, 1, cfg, geom, bdata, ch, physics, t)
    return _partial_update(P, Ph, dt, 2, cfg, geom, bdata, ch, physics, t)


class StepFns(NamedTuple):
    advance: callable   # (P, dt, t=0.0) -> P_new
    calc_dt: callable   # (P,) -> 0-d tensor, dynamical dt
    step: callable      # (P, t, last_dt, dt_cap) -> (P_new, dt, dt_raw)
    # K fused steps in one dispatch; its counterpart here is a CUDA graph,
    # which is not written yet
    multi_step: callable = None


def make_step_fns(cfg: SimConfig, geom: Geometry,
                  bdata: Optional[BoundaryData] = None,
                  physics=None, device=None) -> StepFns:
    """Build the advance/dt functions with the config closed over.

    The functions put the state they are given on ``device``: the CUDA
    device when ``device`` is None (raising if there is none), the CPU only
    when the caller asks for it."""
    _check_physics(physics)
    dev = resolve_device(device)
    dtype = cfg.torch_dtype

    def _state(P):
        return torch.as_tensor(P, dtype=dtype, device=dev)

    def _advance(P, dt, t=0.0):
        return advance(_state(P), dt, cfg, geom, bdata, t=t)

    def _calc_dt(P):
        return dynamics_dt(_state(P), cfg, geom)

    def _step(P, t, last_dt, dt_cap):
        """Fused dt + advance.  dt clamps follow the reference's
        timestep_checking_and_limiting (calc_timestep.cpp:219-260): growth
        limit, then the caller-supplied cap (next output time / finish
        time).  ``last_dt`` and ``dt_cap`` are host numbers; ``dt`` and
        ``dt_raw`` come back as 0-d tensors on the device, unread."""
        P = _state(P)
        dt_raw = dynamics_dt(P, cfg, geom)
        dt = dt_raw
        if last_dt > 0.0:
            dt = torch.clamp(dt, max=cfg.max_dt_growth * last_dt)
        dt = torch.clamp(dt, max=dt_cap)
        Pn = advance(P, dt, cfg, geom, bdata, t=t)
        return Pn, dt, dt_raw

    return StepFns(advance=_advance, calc_dt=_calc_dt, step=_step)
