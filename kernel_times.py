#!/usr/bin/env python3
"""Device times of the sweep kernels (B1, B2), the chemistry update (B3) and
right-hand side (B4) and the point-source trace (B5) on the traffic of the
port's three main paths,
and the host's cost of a call of each wrapper, for comparing two versions of
the port on one card.

    python3 kernel_times.py                      # the port beside this script
    cd OTHER_CHECKOUT && python3 /path/to/kernel_times.py --here

``--here`` imports ``pion_tpu_torch`` from the working directory instead of
the script's own, so that one call can time two checkouts in turns (A, B, B,
A) on the same card.  The states and the timing are ``chip_smoke.py``'s, from
beside this script whichever package is timed: the builders its ``kernels``
phase uses and its ``sweep_mix_ms`` and ``update_ms`` (CUDA events over 20
launches queued behind a busy device).  Needs one CUDA device.  At 128^3
float32 it times:

- B1 on the blast wave (axes 0-2, orders 1 and 2), on the H II region's
  state after six steps (three axes, ``scma``) and on level 1 of the coupled
  hierarchy after eight steps (prolonged ghosts, half ``dx``, wind cells);
- B2 on the blast wave, orders 1 and 2;
- B1 (axes 0-2) and B2 on the Euler blast wave for each Euler solver of the
  kernels (HLL, linear, Roe-CV, Roe-PV), and B1 on configuration 1's blast
  with the MHD linear and Roe-CV solvers (where the port's kernels take
  them: ``fused_sweep.supports``);
- B5 on the H II state's optical depths (128^3 float32), the source at the
  centre (the H II and coupled traffic: 65 shells) and in a corner (128
  shells); where the port has ``fused_trace.trace_plan``, also the plan and
  its dependency floor: the probe ``csrc/trace_floor.cu`` on the same
  clusters running the same 192 (centre) or 381 (corner) rounds of the
  cluster barrier and nothing else, and the same rounds with a relaxed
  arrive;
- B4 on the H II state (one mfion source, no UV); where the port has
  ``fused_mpv3.ydot_plan``, also its plan and the probes of B4's design,
  built from ``csrc/mpv3.cu`` with ``-DPION_YDOT_PROBE``: (a) the first
  design (one block of 256 threads a tile of 1024 cells, the tables staged
  by every block, four cells a thread one after another) and (b) that grid
  doing only its table staging and barrier.  (c), the same cells with the
  tables read in place, is B4 itself since its redesign;
- B3 on the H II state (the step that state takes), on a quiescent state
  (Euler only), on a developed ionisation front, and on both levels of the
  coupled state (seeded with ``f0`` at half the step, unseeded at the step),
  with the ladder tiles and Newton iterations of each call;
- the host's microseconds a call of ``update``, ``ydot`` and ``sweep_axis``
  (order 2) on level 1 of the coupled state, queued behind a busy device.

With ``--paths`` it also times whole steps of the three paths on the host
clock (``Simulation.run`` of the blast and the H II region, ``NGHierarchy.step``
of the coupled flagship, each after two warm-up steps, ending in
``torch.cuda.synchronize()``).

Prints one JSON line a group and, last, the card's name and power limit.
No plain version runs: ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--here", action="store_true",
                    help="import the port from the working directory")
    ap.add_argument("--label", default="", help="a tag for every line")
    ap.add_argument("--paths", action="store_true",
                    help="also time whole steps of the three paths on the "
                         "host clock (blast 10, H II 10, coupled 6 steps)")
    args = ap.parse_args(argv)
    if args.here:
        sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pion_tpu_torch import NGHierarchy, _build
    from pion_tpu_torch.microphysics import fused_mpv3 as fm
    from pion_tpu_torch.ops import fused_sweep as fs

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def emit(group, **kw):
        print(json.dumps({"label": args.label, "group": group, **kw,
                          "elapsed_s": time.perf_counter() - t0}), flush=True)

    def mix(by_case):
        return float(np.mean(list(by_case.values())))

    def b3(mp, omx, E, nH, rt, dt, f0=None):
        _, tiles, newton = cs.update_stats(mp, omx, E, nH, dt, rt, f0=f0)
        return {"ms": cs.update_ms(mp, omx, E, nH, dt, rt, f0=f0),
                "ladder_tiles": tiles, "newton_iterations": newton,
                "cells": omx.numel(), "dt": float(dt)}

    emit("build", seconds=_build.load_all()["seconds"],
         source=os.path.dirname(os.path.abspath(fs.__file__)))

    # --- blast: B1 and B2
    cfg = cs.main_cfg((128,) * 3, "float32")
    geom, P, Ppad, strong, dt, ch = cs.kernel_inputs(cfg, 7, dev)
    b1 = cs.sweep_mix_ms(Ppad, cfg, geom, (0, 1, 2), dt, ch, strong)
    contribs = [fs.sweep_axis(Ppad, cfg, geom, a, 2, dt, ch=ch, strong=strong)
                for a in (1, 2)]
    b2 = {f"order{o}": cs.time_ms(
        lambda: fs.final_axis(P, Ppad, contribs, cfg, geom, o, dt, ch=ch,
                              strong=strong), 20) for o in (1, 2)}
    emit("blast", sweep_axis=b1, sweep_axis_mix_ms=mix(
        {k: v for k, v in b1.items() if not k.startswith("axis0")}),
        final_axis=b2, final_axis_mix_ms=mix(b2))

    # --- the Euler blast with each Euler solver; the MHD linear/Roe blast
    waves = {}
    for kw in ([dict(eqn="euler", solver=s) for s in cs.EULER_SOLVERS]
               + [dict(solver="linear"), dict(solver="roe")]):
        vcfg = cs.main_cfg((128,) * 3, "float32", **kw)
        name = cs.variant(vcfg)
        if not fs.supports(vcfg):
            waves[name] = None
            continue
        vgeom, vP, vpad, vstrong, vdt, vch = cs.kernel_inputs(vcfg, 7, dev)
        vb1 = cs.sweep_mix_ms(vpad, vcfg, vgeom, (0, 1, 2), vdt, vch, vstrong)
        rec = {"sweep_axis": vb1, "sweep_axis_mix_ms": mix(
            {k: v for k, v in vb1.items() if not k.startswith("axis0")})}
        if vcfg.eqn.value == "euler":
            vc = [fs.sweep_axis(vpad, vcfg, vgeom, a, 2, vdt, ch=vch)
                  for a in (1, 2)]
            vb2 = {f"order{o}": cs.time_ms(
                lambda: fs.final_axis(vP, vpad, vc, vcfg, vgeom, o, vdt,
                                      ch=vch), 20) for o in (1, 2)}
            rec.update(final_axis=vb2, final_axis_mix_ms=mix(vb2))
        waves[name] = rec
        del vP, vpad, vstrong
    emit("solver_variants", **waves)

    # --- the H II region after six steps: B1 (scma) and B3
    sim, P0 = cs.hii_run(128, 6)
    hpad, hstrong, hdt, hch, scma = cs.hii_sweep_inputs(sim, sim.P)
    hb1 = cs.sweep_mix_ms(hpad, sim.cfg, sim.geom, range(3), hdt, hch,
                          hstrong, scma=scma)
    emit("hii_sweep", sweep_axis=hb1, sweep_axis_mix_ms=mix(hb1))
    mp = sim.physics.mp
    run_state = b3(mp, *mp.local_state(sim.P), sim.physics.raytrace(sim.P),
                   float(hdt))
    q_state, q_rt = cs.quiescent_inputs(mp, P0, sim.P)
    quiescent = b3(mp, *q_state, q_rt, 1.0e7)
    Pf = cs.front_state(sim, P0, 128 * 3.0 / 16.0)
    front = b3(mp, *mp.local_state(Pf), sim.physics.raytrace(Pf),
               float(sim.fns.calc_dt(Pf)))
    emit("hii_update", run_state=run_state, quiescent=quiescent, front=front)
    emit("hii_ydot", **ydot_times(cs, sim, torch))
    emit("trace", **trace_times(cs, sim, torch))
    del sim

    # --- the coupled hierarchy after eight steps: B1 on level 1, B3 on both
    ccfg, states, make_cphys = cs.coupled_problem(128, "float32")
    hier = NGHierarchy(ccfg, 2, physics=make_cphys())
    hier.set_states(states)
    for _ in range(8):
        hier.step()
    cfg1, geom1, npad, nstrong, ndt, nch, nscma = cs.ng_sweep_inputs(hier)
    nb1 = cs.sweep_mix_ms(npad, cfg1, geom1, range(3), ndt, nch, nstrong,
                          scma=nscma)
    emit("ng_sweep", level=1, sweep_axis=nb1, sweep_axis_mix_ms=mix(nb1))
    levels = {}
    for lv in range(2):
        mpl, o_, e_, n_, rtl, dtl = cs.ng_update_inputs(hier, lv)
        f0 = fm.ydot(mpl, o_, e_, n_, rtl)
        levels[f"level{lv}"] = {
            "predictor_seeded": b3(mpl, o_, e_, n_, rtl, 0.5 * dtl, f0=f0),
            "corrector": b3(mpl, o_, e_, n_, rtl, dtl)}
    emit("ng_update", **levels)

    # --- the host's cost of a wrapper call, level 1 of the coupled state
    # (mpl ... dtl are level 1's, the loop's last), the step on the card
    dt_dev = cs.device_scalar(dtl, o_)
    emit("host_us_per_call", level=1,
         update=host_us(lambda: fm.update(mpl, o_, e_, n_, dt_dev, rtl)),
         ydot=host_us(lambda: fm.ydot(mpl, o_, e_, n_, rtl)),
         sweep_axis_order2=host_us(lambda: fs.sweep_axis(
             npad, cfg1, geom1, 1, 2, ndt, ch=nch, scma=nscma,
             strong=nstrong)))
    del hier

    if args.paths:
        emit("paths", **path_times(cs, torch))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


def trace_times(cs, sim, torch) -> dict:
    """B5 on the H II state's optical depths: ms a launch with the source at
    the centre and in a corner; with ``trace_plan``, the plan and its
    barrier-only floor."""
    from pion_tpu_torch import _build
    from pion_tpu_torch.raytracing import fused_trace as ft

    phys, P = sim.physics, sim.P
    tr = phys.raytracer.point_tracers[0]
    dtau = phys.dtau_for(phys.sources[0], P,
                         phys.raytracer.static_fields(0, P)[0])
    out = {}
    for name, src in (("centre", tuple(int(v) for v in tr.src_idx)),
                      ("corner", (0, 0, 0))):
        rec = {"source_cell": list(src), "ms": cs.time_ms(
            lambda: ft.octant_trace(dtau, src, tr.tau_min), 20)}
        if hasattr(ft, "trace_plan"):
            plan = ft.trace_plan(tuple(dtau.shape), src, dtau.element_size())
            rec["plan"] = dict(plan)
            lib = _build.get_probe_lib("trace_floor")
            phases = 3 * (plan["shells"] - 1)

            def floor(relaxed):
                err = lib.pion_trace_barrier_floor(
                    plan["cluster"], plan["threads"], phases, relaxed,
                    torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"barrier floor launch: CUDA error {err}")

            rec["barrier_phases"] = phases
            rec["barrier_floor_ms"] = cs.time_ms(lambda: floor(0), 20)
            # the same rounds with a relaxed arrive: what the release costs
            rec["barrier_relaxed_ms"] = cs.time_ms(lambda: floor(1), 20)
        out[name] = rec
    return out


def ydot_times(cs, sim, torch) -> dict:
    """B4 on the H II state: ms a call of the wrapper; with ``ydot_plan``,
    the plan, the kernel launched alone, and the two probes of its first
    design, the full one held against the wrapper's result."""
    from pion_tpu_torch import _build
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    mp, P = sim.physics.mp, sim.P
    omx, E, nH = mp.local_state(P)
    rt = sim.physics.raytrace(P)
    got = fm.ydot(mp, omx, E, nH, rt)
    out = {"cells": omx.numel(), "sources": len(fm._entries(rt)),
           "ms": cs.time_ms(lambda: fm.ydot(mp, omx, E, nH, rt), 20)}
    if not hasattr(fm, "ydot_plan"):
        return out
    out["plan"] = dict(fm.ydot_plan(omx.numel()))
    lib = _build.get_probe_lib("ydot_probe")
    main_lib, head, tail, keep = fm._launch_args(mp, omx, E, nH, rt)
    d_o, d_e = torch.empty_like(omx), torch.empty_like(omx)

    def kernel():
        err = main_lib.pion_mpv3_ydot(
            *head, d_o.data_ptr(), d_e.data_ptr(), *tail,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ydot kernel: CUDA error {err}")

    # the kernel alone, its inputs made once: the wrapper also writes
    # Ndot/Vshell out as a plane and copies the tau table at every call
    out["kernel_ms"] = cs.time_ms(kernel, 20)

    def probe(which):
        err = lib.pion_mpv3_ydot_probe(
            which, *head, d_o.data_ptr(), d_e.data_ptr(), *tail,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ydot probe {which}: CUDA error {err}")

    probe(0)
    torch.cuda.synchronize()
    out["first_design"] = {
        "ms": cs.time_ms(lambda: probe(0), 20),
        "soft_rel_diff_to_ydot": max(float(cs.soft_err(a, b))
                                     for a, b in zip((d_o, d_e), got))}
    out["staging_only"] = {"ms": cs.time_ms(lambda: probe(1), 20)}
    del keep
    return out


def host_us(fn, n: int = 30) -> float:
    """Host microseconds a call of ``fn``, the calls queued behind a device
    kept busy for about a second, so that none waits for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1.0e6
    torch.cuda.synchronize()
    return t


def path_times(cs, torch) -> dict:
    """ms a step on the host clock of the three paths at 128^3 float32."""
    from pion_tpu_torch import NGHierarchy, Simulation
    from pion_tpu_torch.ics import blast_wave

    def timed(run, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1.0e3

    def sim_run(sim):
        return lambda n: sim.run(max_steps=sim.step_count + n)

    out = {}
    cfg = cs.main_cfg((128,) * 3, "float32")
    sim = Simulation(cfg, blast_wave(cfg, B0=(0.1, 0.05, 0.0)))
    sim.run(max_steps=2)
    out["blast_ms_per_step"] = timed(sim_run(sim), 10)
    hcfg, P0, make_physics = cs.hii_problem(128, "float32")
    sim = Simulation(hcfg, P0, physics=make_physics())
    sim.run(max_steps=2)
    out["hii_ms_per_step"] = timed(sim_run(sim), 10)
    ccfg, states, make_cphys = cs.coupled_problem(128, "float32")
    hier = NGHierarchy(ccfg, 2, physics=make_cphys())
    hier.set_states(states)
    for _ in range(2):
        hier.step()
    out["coupled_ms_per_step"] = timed(
        lambda n: [hier.step() for _ in range(n)], 6)
    return out


if __name__ == "__main__":
    sys.exit(main())
