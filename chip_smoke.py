#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as described below
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes only

Needs one CUDA device and ``nvcc``; there is no CPU mode.  It builds the CUDA
kernels of ``pion_tpu_torch/csrc`` from source, holds each kernel against its
plain PyTorch version on the card, then drives the port's main path — the 3D
GLM-MHD blast wave through ``Simulation.run`` at 128^3 in float32 — and checks
that the run went through the kernels and that what came out is right.  Every
phase prints one JSON line; any failed check raises, and the process then
exits non-zero without the closing ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate and
# the float32 / float64 rates outside the tensor cores.  Bounds are stated
# against these whatever power limit the card at hand is set to.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67.0e12, torch.float64: 34.0e12}

SOURCE = "pion_tpu_torch/csrc/sweep.cu"
TOL = {torch.float64: 1.0e-10,   # same arithmetic, other order and FMA use
       torch.float32: 2.0e-5}    # FMA contraction and reassociation in float32


def main_cfg(shape, dtype, **kw):
    from pion_tpu_torch import SimConfig

    n = shape[-1]
    return SimConfig(ndim=len(shape), eqn="glm", solver="hlld", ntracer=1,
                     shape=tuple(shape), xmin=(0.0,) * len(shape),
                     xmax=tuple(s / n for s in shape),
                     bcs=(("outflow", "outflow"),) * len(shape), cfl=0.3,
                     ooa=2, av="falle", etav=0.1, dtype=dtype, **kw)


def noisy_state(cfg, seed: int) -> np.ndarray:
    """Blast wave with seeded noise on velocities, field and psi and a
    non-constant tracer in [0, 1], so that viscosity, upwinding, the Powell
    and GLM sources and the fallback mask all have something to act on."""
    from pion_tpu_torch.constants import BX, VX
    from pion_tpu_torch.ics import blast_wave

    rng = np.random.default_rng(seed)
    P = blast_wave(cfg, B0=(0.1, 0.05, 0.02))
    P[VX:VX + 3] += 0.1 * rng.standard_normal((3,) + cfg.shape)
    P[BX:BX + 3] += 0.02 * rng.standard_normal((3,) + cfg.shape)
    nb = cfg.eqn.nbase
    if cfg.eqn.value == "glm":
        P[nb - 1] = 0.01 * rng.standard_normal(cfg.shape)
    for v in range(nb, cfg.nvar):
        P[v] = rng.random(cfg.shape)
    return P


def scaled_err(out: torch.Tensor, ref: torch.Tensor):
    """(max over variables of max|out-ref| / max|ref_v|, max|out-ref|)."""
    nv = out.shape[0]
    diff = (out - ref).abs().reshape(nv, -1).amax(dim=1).double()
    scale = ref.abs().reshape(nv, -1).amax(dim=1).double()
    tiny = torch.finfo(out.dtype).tiny
    rel = (diff / scale.clamp(min=tiny)).max().item()
    return rel, diff.max().item()


def kernel_inputs(cfg, seed, device):
    """Padded state, mask, base state, dt and ch on the card for one
    configuration, from seeded numpy data."""
    from pion_tpu_torch.boundaries import apply_bcs
    from pion_tpu_torch.grid import make_geometry
    from pion_tpu_torch.ops.sweep import hlld_fallback_cells
    from pion_tpu_torch.ops.timestep import dynamics_dt

    geom = make_geometry(cfg)
    P = torch.from_numpy(noisy_state(cfg, seed).astype(cfg.np_dtype)).to(device)
    Ppad = apply_bcs(P, cfg).contiguous()
    dt = dynamics_dt(P, cfg, geom)
    ch = cfg.cfl * geom.dx / dt
    strong = None
    if cfg.solver.value == "hlld" and cfg.hlld_fallback:
        strong = hlld_fallback_cells(Ppad, cfg, geom.dx)
        ns = int(strong.sum().item())
        if not 0 < ns < strong.numel():
            raise AssertionError(f"fallback mask degenerate: {ns} of "
                                 f"{strong.numel()} cells flagged")
    return geom, P, Ppad, strong, dt, ch


def check_case(cfg, seed, device, scma=False):
    """Both kernels against their plain versions for one configuration, every
    axis and both orders.  Returns the worst scaled errors (b1, b2)."""
    from pion_tpu_torch.ops import fused_sweep as fs

    geom, P, Ppad, strong, dt, ch = kernel_inputs(cfg, seed, device)
    tol = TOL[Ppad.dtype]
    worst1 = worst2 = 0.0
    for order in (1, 2):
        contribs = []
        for axis in range(cfg.ndim):
            out = fs.sweep_axis(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                scma=scma, strong=strong)
            ref = fs.sweep_axis_plain(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                      scma=scma)
            torch.cuda.synchronize()
            rel, _ = scaled_err(out, ref)
            if not rel <= tol:
                raise AssertionError(
                    f"sweep_axis disagrees with its plain version: {rel:.3e} "
                    f"> {tol:.1e} ({cfg.dtype} {cfg.eqn.value} "
                    f"{cfg.solver.value} av={cfg.av.value} shape={cfg.shape} "
                    f"axis={axis} order={order} mask={strong is not None} "
                    f"scma={scma})")
            worst1 = max(worst1, rel)
            if axis:
                contribs.append(ref)
        if scma:
            continue   # the fused update runs only without microphysics
        out = fs.final_axis(P, Ppad, contribs, cfg, geom, order, dt, ch=ch,
                            strong=strong)
        ref = fs.final_axis_plain(P, Ppad, contribs, cfg, geom, order, dt,
                                  ch=ch)
        torch.cuda.synchronize()
        rel, _ = scaled_err(out, ref)
        if not rel <= tol:
            raise AssertionError(
                f"final_axis disagrees with its plain version: {rel:.3e} > "
                f"{tol:.1e} ({cfg.dtype} {cfg.eqn.value} {cfg.solver.value} "
                f"av={cfg.av.value} shape={cfg.shape} order={order} "
                f"mask={strong is not None})")
        worst2 = max(worst2, rel)
    return worst1, worst2


def check_kernels(device):
    """The case matrix at small shapes that are no multiple of the block
    size: 3D and 2D, both dtypes, GLM and MHD, HLLD with and without the
    mask, HLL, viscosity on and off, tracers and the sCMA variants."""
    from pion_tpu_torch import SimConfig

    worst = {}
    ncase = 0
    for dtype in ("float64", "float32"):
        cases = []
        for shape in ((12, 20, 36), (20, 36)):
            for fallback in (True, False):
                cases.append((main_cfg(shape, dtype, hlld_fallback=fallback),
                              False))
            nd = len(shape)
            box = dict(ndim=nd, shape=shape, xmin=(0.0,) * nd,
                       xmax=tuple(s / shape[-1] for s in shape),
                       bcs=(("outflow", "outflow"),) * nd, dtype=dtype)
            cases.append((SimConfig(eqn="mhd", solver="hll", av="falle",
                                    ntracer=0, **box), False))
            cases.append((SimConfig(eqn="glm", solver="hlld", av="none",
                                    ntracer=2, **box), False))
            cases.append((SimConfig(eqn="mhd", solver="hlld", av="none",
                                    ntracer=3, **box), True))
            cases.append((SimConfig(eqn="glm", solver="hll", av="falle",
                                    ntracer=3, **box), (10, 11)))
        w1 = w2 = 0.0
        for i, (cfg, scma) in enumerate(cases):
            a, b = check_case(cfg, 100 + i, device, scma=scma)
            w1, w2 = max(w1, a), max(w2, b)
            ncase += 1
        worst[dtype] = (w1, w2)
    return worst, ncase


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: int, flops: int, dtype):
    """Least time the card could take, in ms, and which side sets it."""
    tb = nbytes / PEAK_BYTES_PER_S * 1.0e3
    to = flops / PEAK_FLOPS[dtype] * 1.0e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def measure_kernels(device, worst, shape=(128, 128, 128)):
    """Each kernel at the main path's shapes (128^3, nvar 10, float32): held
    against its plain version, then timed beside it.  The main path launches
    the axis kernel on axes 1 and 2 and the final kernel on axis 0, each at
    order 1 (predictor) and order 2 (corrector); times are means over that
    mix."""
    from pion_tpu_torch.ops import fused_sweep as fs

    cfg = main_cfg(shape, "float32")
    geom, P, Ppad, strong, dt, ch = kernel_inputs(cfg, 7, device)
    cells = int(np.prod(cfg.shape))
    esz = Ppad.element_size()
    tol = TOL[Ppad.dtype]
    contribs = [fs.sweep_axis_plain(Ppad, cfg, geom, a, 2, dt, ch=ch)
                for a in (1, 2)]

    rows = []
    # --- sweep_axis (B1)
    abs1 = rel1 = 0.0
    ms1, plain1, cases1 = [], [], {}
    for axis in (1, 2):
        for order in (1, 2):
            def kern():
                return fs.sweep_axis(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                     strong=strong)

            def plain():
                return fs.sweep_axis_plain(Ppad, cfg, geom, axis, order, dt,
                                           ch=ch)

            rel, ab = scaled_err(kern(), plain())
            if not rel <= tol:
                raise AssertionError(f"sweep_axis at 128^3 axis={axis} "
                                     f"order={order}: {rel:.3e} > {tol:.1e}")
            rel1, abs1 = max(rel1, rel), max(abs1, ab)
            k_ms, p_ms = time_ms(kern, 20), time_ms(plain, 3, warmup=1)
            ms1.append(k_ms)
            plain1.append(p_ms)
            cases1[f"axis{axis}_order{order}"] = k_ms
    n_if = cells // cfg.shape[1] * (cfg.shape[1] + 1)
    b_ms, b_by = bound(
        Ppad.numel() * esz + strong.numel() + 2 * esz + cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2, Ppad.dtype)
    rows.append({
        "name": "sweep_axis", "route": "cuda", "source": SOURCE,
        "replaces": "pion_tpu/ops/pallas_sweep.py:510", "launches": None,
        "max_abs_err": abs1, "max_rel_err_f32_128": rel1,
        "max_rel_err_f64": worst["float64"][0],
        "max_rel_err_f32": worst["float32"][0],
        "ms": float(np.mean(ms1)), "plain_ms": float(np.mean(plain1)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_by_case": cases1})

    # --- final_axis (B2)
    abs2 = rel2 = 0.0
    ms2, plain2, cases2 = [], [], {}
    for order in (1, 2):
        def kern():
            return fs.final_axis(P, Ppad, contribs, cfg, geom, order, dt,
                                 ch=ch, strong=strong)

        def plain():
            return fs.final_axis_plain(P, Ppad, contribs, cfg, geom, order,
                                       dt, ch=ch)

        rel, ab = scaled_err(kern(), plain())
        if not rel <= tol:
            raise AssertionError(f"final_axis at 128^3 order={order}: "
                                 f"{rel:.3e} > {tol:.1e}")
        rel2, abs2 = max(rel2, rel), max(abs2, ab)
        k_ms, p_ms = time_ms(kern, 20), time_ms(plain, 3, warmup=1)
        ms2.append(k_ms)
        plain2.append(p_ms)
        cases2[f"order{order}"] = k_ms
    n_if = cells // cfg.shape[0] * (cfg.shape[0] + 1)
    b_ms, b_by = bound(
        Ppad.numel() * esz + strong.numel() + 2 * esz
        + (2 + len(contribs)) * cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2 + 80 * cells,
        Ppad.dtype)
    rows.append({
        "name": "final_axis", "route": "cuda", "source": SOURCE,
        "replaces": "pion_tpu/ops/pallas_sweep.py:639", "launches": None,
        "max_abs_err": abs2, "max_rel_err_f32_128": rel2,
        "max_rel_err_f64": worst["float64"][1],
        "max_rel_err_f32": worst["float32"][1],
        "ms": float(np.mean(ms2)), "plain_ms": float(np.mean(plain2)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_by_case": cases2})
    return rows


def step_parts(device, shape=(128, 128, 128), steps: int = 10):
    """Where a step's time goes outside the two kernels: the plain passes
    timed alone with CUDA events, and the device time of a short profiled
    run summed by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from pion_tpu_torch import Simulation
    from pion_tpu_torch.boundaries import apply_bcs
    from pion_tpu_torch.ics import blast_wave
    from pion_tpu_torch.ops.sweep import hlld_fallback_cells
    from pion_tpu_torch.ops.timestep import dynamics_dt

    cfg = main_cfg(shape, "float32")
    geom, P, Ppad, strong, dt, ch = kernel_inputs(cfg, 7, device)
    parts = {
        "apply_bcs_ms": time_ms(lambda: apply_bcs(P, cfg), 20),
        "hlld_fallback_cells_ms": time_ms(
            lambda: hlld_fallback_cells(Ppad, cfg, geom.dx), 20),
        "dynamics_dt_ms": time_ms(lambda: dynamics_dt(P, cfg, geom), 20),
    }
    sim = Simulation(cfg, blast_wave(cfg, B0=(0.1, 0.05, 0.0)))
    sim.run(max_steps=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(max_steps=3 + steps)
        torch.cuda.synchronize()
    # kernels only: an operator's row repeats the time of the kernels it
    # launched
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
    dev_ms = sum(by_name.values()) / 1.0e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    parts.update({
        "profiled_steps": steps,
        # null when the profiler saw no device activity
        "device_ms_per_step": dev_ms / steps if dev_ms > 0 else None,
        "top_device_ms_per_step": {k[:60]: v / 1.0e3 / steps for k, v in top},
    })
    return parts


def reset_counts():
    from pion_tpu_torch.ops import fused_sweep as fs

    fs.sweep_axis.launches = 0
    fs.final_axis.launches = 0


def read_counts():
    from pion_tpu_torch.ops import fused_sweep as fs

    return {"sweep_axis": fs.sweep_axis.launches,
            "final_axis": fs.final_axis.launches}


def timed_run(sim, steps: int):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.run(max_steps=sim.step_count + steps)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return sec, torch.cuda.max_memory_allocated()


def main_path(shape, dtype, steps: int, agree_tol: float, plain_steps: int):
    """The library's main path as a user calls it: ``Simulation(cfg,
    P0).run(max_steps=N)`` on the blast wave.  Returns the phase record and
    the launch counts of the counted run."""
    from pion_tpu_torch import Simulation
    from pion_tpu_torch.ics import blast_wave
    from pion_tpu_torch.utils import conservation_totals

    cfg = main_cfg(shape, dtype)
    P0 = blast_wave(cfg, B0=(0.1, 0.05, 0.0))
    cells = int(np.prod(shape))

    Simulation(cfg, P0).run(max_steps=2)       # warm-up, not counted

    sim = Simulation(cfg, P0)
    mass0 = conservation_totals(sim.P, cfg, sim.geom)["mass"]
    reset_counts()
    sec, peak = timed_run(sim, steps)
    counts = read_counts()

    if sim.step_count != steps or not sim.t > 0.0:
        raise AssertionError(f"run ended at step {sim.step_count}, t={sim.t}")
    if tuple(sim.P.shape) != (cfg.nvar,) + cfg.shape:
        raise AssertionError(f"state shape {tuple(sim.P.shape)}")
    if not bool(torch.isfinite(sim.P).all()):
        raise AssertionError("non-finite values in the state")
    want = {"sweep_axis": 4 * steps, "final_axis": 2 * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    mass1 = conservation_totals(sim.P, cfg, sim.geom)["mass"]
    mass_err = abs(mass1 - mass0) / abs(mass0)
    if not mass_err <= 1.0e-5:
        raise AssertionError(f"mass not conserved: relative change {mass_err}")

    # the same steps through the kernels and through the plain sweep, from
    # the evolved state
    clock = dict(t=sim.t, step_count=sim.step_count, last_dt=sim.last_dt)
    a = Simulation(cfg, sim.P, **clock).run(max_steps=steps + 2)
    cfg_off = dataclasses.replace(cfg, kernels="off")
    b = Simulation(cfg_off, sim.P, **clock)
    sec_off, peak_off = timed_run(b, 2)
    rel, _ = scaled_err(a.P, b.P)
    if not rel <= agree_tol:
        raise AssertionError(f"kernel and plain paths disagree after 2 "
                             f"steps: {rel:.3e} > {agree_tol:.1e}")
    if abs(a.t - b.t) > 1.0e-6 * abs(b.t):
        raise AssertionError(f"clocks disagree: {a.t} vs {b.t}")
    if plain_steps > 2:
        sec_off, peak_off = timed_run(b, plain_steps)
    else:
        plain_steps = 2
    rec = {
        "shape": list(shape), "dtype": dtype, "steps": steps, "t": sim.t,
        "launches": counts, "mass_rel_change": mass_err,
        "kernels_vs_plain_2_steps": rel,
        "steps_per_s": steps / sec, "cell_updates_per_s": cells * steps / sec,
        "peak_mem_bytes": peak,
        "plain_steps_per_s": plain_steps / sec_off,
        "plain_cell_updates_per_s": cells * plain_steps / sec_off,
        "plain_peak_mem_bytes": peak_off,
    }
    return rec, counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at small shapes, then "
                         "stop (prints no closing line)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="also write every phase's full record to "
                         "DIR/chip_smoke.json")
    args = ap.parse_args(argv)
    records = {}

    def emit(phase, **kw):
        records[phase] = kw
        print(json.dumps({"phase": phase, **kw}), flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
                json.dump(records, f, indent=1)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from pion_tpu_torch import _build

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    info = _build.load_all()
    # per library: [kernel, registers, spill stores, spill loads] of the
    # instantiation with the most registers and of the one that spills most
    emit("build", seconds=info["seconds"], built=info["built"],
         ptxas={name: {"kernels": len(rows),
                       "max_registers": max(rows, key=lambda r: r["registers"]),
                       "max_spill": max(rows, key=lambda r: r["spill_stores"])}
                for name, rows in info["variants"].items() if rows})
    if args.out:
        with open(os.path.join(args.out, "ptxas.json"), "w") as f:
            json.dump(info["variants"], f, indent=1)

    worst, ncase = check_kernels(device)
    emit("kernel_checks", cases=ncase,
         max_rel_err={k: {"sweep_axis": v[0], "final_axis": v[1]}
                      for k, v in worst.items()}, tol={"float64": TOL[torch.float64],
                                                       "float32": TOL[torch.float32]})
    if args.quick:
        return 0

    rows = measure_kernels(device, worst)
    emit("kernels", kernels=rows)

    rec32, counts = main_path((128, 128, 128), "float32", steps=20,
                              agree_tol=1.0e-4, plain_steps=5)
    emit("main_path", **rec32)
    parts = step_parts(device)
    if parts["device_ms_per_step"] is not None:
        # idle share of the device in the unprofiled run above
        parts["device_idle_share"] = max(
            0.0, 1.0 - parts["device_ms_per_step"] * rec32["steps_per_s"] / 1.0e3)
    emit("step_parts", **parts)
    rec64, _ = main_path((64, 64, 64), "float64", steps=5, agree_tol=1.0e-9,
                         plain_steps=2)
    emit("main_path_f64", **rec64)

    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
