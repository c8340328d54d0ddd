"""The plain reference's run of a cell, its control, and the comparison that
decides ``correct``.

The reference is the package ``reference/<name>/`` that the configuration
names under ``reference``, resolved by ``problems.reference_of``: by default
``port_plain``, a frozen copy of the port's plain path (``kernels="off"``:
plain PyTorch, no kernel, no CUDA graph).  A configuration that needs a path
``port_plain`` leaves out brings a package of its own beside it, which may
import ``port_plain`` to share its unchanged modules and imports nothing of
the program.  It is built from the benchmark's own inputs and stepped one
step at a time.  The control is the same reference with its state held in
bfloat16, the precision below the configuration's float32: the inputs and
the state after every step rounded to bfloat16.

Three numbers are compared, each against a limit of the cell
(``limits/<cell>.json``): over every level and every group of variables,

- ``state_l1``: the largest sum of |program - reference| over the sum of
  |reference| of a group (mass, pressure, velocity, field, tracers);
- ``state_linf``: the largest max |program - reference| over max |reference|
  of a group;
- ``clock_rel``: |t_program - t_reference| / t_reference.

The GLM scalar psi is left out: it holds rounding noise times the cleaning
speed, and what it does shows in the field.
"""
from __future__ import annotations

import math

import torch

RO, PG, VX, BX = 0, 1, 2, 5


def groups(nvar: int, nbase: int, mhd: bool) -> dict:
    out = {"mass": [RO], "pressure": [PG], "velocity": [VX, VX + 1, VX + 2]}
    if mhd:
        out["field"] = [BX, BX + 1, BX + 2]
    if nvar > nbase:
        out["tracers"] = list(range(nbase, nvar))
    return out


def numbers(prog: list, prog_t: float, ref: list, ref_t: float,
            cfg) -> dict:
    """The compared numbers of the program's level states ``prog`` and
    clock against the reference's (any devices; compared in float64 on
    the reference's device).  A non-finite state reads infinity."""
    g = groups(cfg.nvar, cfg.eqn.nbase, cfg.eqn.is_mhd)
    l1 = linf = 0.0
    for a, b in zip(prog, ref):
        b = b.double()
        a = a.to(device=b.device, dtype=torch.float64)
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            return {"state_l1": math.inf, "state_linf": math.inf,
                    "clock_rel": math.inf}
        for rows in g.values():
            d = (a[rows] - b[rows]).abs()
            r = b[rows].abs()
            l1 = max(l1, float(d.sum() / r.sum().clamp_min(1e-300)))
            linf = max(linf, float(d.max() / r.max().clamp_min(1e-300)))
    clock = abs(prog_t - ref_t) / abs(ref_t) if ref_t else abs(prog_t)
    return {"state_l1": l1, "state_linf": linf, "clock_rel": clock}


def states_of(run) -> list:
    return list(run.P) if isinstance(run.P, (list, tuple)) else [run.P]


def _round_bf16(run) -> None:
    for P in states_of(run):
        P.copy_(P.to(torch.bfloat16).to(P.dtype))


def reference_run(config: dict, states: list, steps: int, device,
                  control: bool = False):
    """The reference over ``steps`` single steps from the inputs
    ``states``: its level states and its clock.  ``control``: the state held
    in bfloat16."""
    from bench_port.problems import make_run, reference_of

    run = make_run(reference_of(config), config, states, kernels="off",
                   device=device)
    if control:
        _round_bf16(run)
    for _ in range(steps):
        run.run(max_steps=run.step_count + 1)
        if control:
            _round_bf16(run)
    if run.step_count != steps:
        raise RuntimeError(f"the reference took {run.step_count} of "
                           f"{steps} steps")
    return states_of(run), run.t
