#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as described below
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes only

Needs one CUDA device and ``nvcc``; there is no CPU mode.  It builds the CUDA
kernels of ``pion_tpu_torch/csrc`` from source, holds each kernel against its
plain PyTorch version on the card, then drives the port's two main paths
through ``Simulation.run`` at 128^3 in float32 — the 3D GLM-MHD blast wave,
and the photoionised H II region around an O star (MPv3 chemistry, point-source
raytrace, GLM-MHD) — and checks that each run went through its kernels and
that what came out is right.  Every phase prints one JSON line; any failed
check raises, and the process then exits non-zero without the closing
``{"ok": true, ...}`` line.
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
MP_SOURCE = "pion_tpu_torch/csrc/mpv3.cu"
TRACE_SOURCE = "pion_tpu_torch/csrc/trace.cu"
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
    """Mean time of one call by CUDA events.  The card is first kept busy for
    some 50 ms, so that launches which take the host longer to queue than the
    card to run queue up behind it and then run back to back: device time,
    not queueing time.  (A plain version that reads back to the host waits
    out the delay before the first event and is timed as before.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
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
            k_ms = time_ms(kern, 20)
            p_ms = time_ms(plain, 3, warmup=1)
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
        k_ms = time_ms(kern, 20)
        p_ms = time_ms(plain, 3, warmup=1)
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
    parts.update(device_time_by_kernel(
        lambda: sim.run(max_steps=3 + steps), steps, top_n=8))
    return parts


def _wrappers():
    from pion_tpu_torch.microphysics import fused_mpv3 as fm
    from pion_tpu_torch.ops import fused_sweep as fs
    from pion_tpu_torch.raytracing import fused_trace as ft

    return {"sweep_axis": fs.sweep_axis, "final_axis": fs.final_axis,
            "mpv3_update": fm.update, "mpv3_ydot": fm.ydot,
            "octant_trace": ft.octant_trace}


def reset_counts():
    for w in _wrappers().values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in _wrappers().items()}


# ---------------------------------------------------------------------------
# chemistry and raytrace kernels
# ---------------------------------------------------------------------------

# ydot: sums of rates that pass through zero, so errors are taken relative to
# max(|ref|, 1e-6 max|ref|).  float64: other order, FMA, 1-2 ulp in exp/log/pow.
# float32: the same plus the cancellation in the (r0 - r1) photo-rate
# difference (read: 6e-4 on the seeded states).
YDOT_TOL = {torch.float64: (1.0e-10, 1.0e-10),
            torch.float32: (5.0e-3, 5.0e-3)}
# update at a moderate step (1e3 s on these states: tiles take 2 to 32
# substeps and Newton converges): a Newton loop may cross its stopping
# tolerance (1e-11 / 1e-6) one iteration apart (read: 9e-15 / 1e-6).
UPDATE_TOL = {torch.float64: 1.0e-8, torch.float32: 1.0e-4}
# update at a step far too long (1e9 s): every tile takes 32 substeps of 8
# Newton iterations that do not converge, and that iterated map amplifies a
# last-bit difference about 1e9 times in some cells (measured: 1e-12 after 2
# substeps, 3e-2 in 0.6 % of the cells after 32, float64).  Held there: the
# share of cells beyond UPDATE_TOL in float64, the median in both types.
STIFF_SHARE = 0.05
STIFF_MEDIAN = 0.05
# trace: the same four-term weighted mean in another order, 64-127 cells deep
TRACE_TOL = {torch.float64: 1.0e-12, torch.float32: 5.0e-6}


def ladder_agrees(kernel_tiles: int, plain_tiles: int) -> bool:
    """Whether the kernel and its plain version sent the same tiles through
    the ladder: equal, but for a tile whose only stiff cell sits on the Euler
    cutoff in one version's rounding (one tile, or 1 % of them)."""
    return abs(kernel_tiles - plain_tiles) <= max(1, plain_tiles // 100)


def soft_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out-ref| / max(|ref|, 1e-6 max|ref|)."""
    sc = torch.clamp(ref.abs(), min=float(ref.abs().max()) * 1.0e-6)
    return float(((out - ref).abs() / sc).max())


def make_mp(ion, n_diff=0):
    from pion_tpu_torch.constants import RSUN
    from pion_tpu_torch.microphysics import MPv3, MPv3Config

    mf = ion == "mfion"
    return MPv3(MPv3Config(
        tracer_slot=9, ion_src=ion, n_idot=1.0e48, tstar=3.75e4 if mf else 0.0,
        rstar_cm=10 * RSUN if mf else 0.0, min_temperature=50.0,
        n_diff_srcs=n_diff))


def mp_inputs(mp, shape, k, dtype, device, seed):
    """Seeded cell states and an rt dict with ``k`` ionizing sources: density
    over four decades, 60 K to 1e6 K, any ionization fraction; columns from
    1e-3 to 100 where photoionization is stiff, and a shielded stretch."""
    from pion_tpu_torch.constants import K_B

    rng = np.random.default_rng(seed)
    c = mp.mpc
    nH = 10 ** rng.uniform(0, 4, shape)
    T = 10 ** rng.uniform(1.8, 6, shape)
    x = rng.uniform(1e-6, 1 - 1e-6, shape)
    E = (c.n_ion + c.n_elec * x) * nH * K_B * T / (c.gamma - 1.0)
    tau0 = 10 ** rng.uniform(-3, 2, shape)
    tau0.reshape(-1)[: tau0.size // 5] = 1.0e6       # a shielded stretch

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    z = torch.zeros(shape, dtype=dtype, device=device)
    ents = []
    for j in range(k):
        ents.append({"tau0": t(tau0 * (1.0 + j)), "ds": z + 3.0e16,
                     "nv": z + 1.0e-3 / (1 + j), "sv": z + 1.0e-3 / (1 + j)})
    rt = {"ion": tuple(ents), "g0_uv": t(rng.uniform(0, 50, shape)),
          "g0_ir": t(rng.uniform(0, 50, shape))}
    return t(1.0 - x), t(E), t(nH), rt


def check_mpv3(device, shape=(7, 33, 41)):
    """B4 and B3 against their plain versions: float32 and float64, no / mono
    / multifrequency ionization, one and two sources, UV heating on and off,
    with and without the caller's first evaluation, on a grid that is no
    multiple of the 1024-cell tile.  Five sources: more than the update keeps
    its column lookup for through the ladder, and in float64 more tables than
    fit in shared memory."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    worst = {}
    ncase = 0
    ladder = []
    for dtype in (torch.float64, torch.float32):
        wy = wu = ws = 0.0
        for ion, k, n_diff in ((None, 1, 0), (None, 1, 1), ("mono", 1, 0),
                               ("mono", 2, 1), ("mfion", 1, 0),
                               ("mfion", 2, 0), ("mfion", 1, 1),
                               ("mfion", 5, 0)):
            mp = make_mp(ion, n_diff=n_diff)
            omx, E, nH, rt = mp_inputs(mp, shape, k, dtype, device, 40 + ncase)
            got = fm.ydot(mp, omx, E, nH, rt)
            ref = fm.ydot_plain(mp, omx, E, nH, rt)
            torch.cuda.synchronize()
            for g, r, tol in zip(got, ref, YDOT_TOL[dtype]):
                err = soft_err(g, r)
                if not err <= tol:
                    raise AssertionError(
                        f"mpv3 ydot disagrees with its plain version: "
                        f"{err:.3e} > {tol:.1e} ({dtype} ion={ion} K={k} "
                        f"uv={n_diff})")
                wy = max(wy, err)
            # the caller's first evaluation: once per dtype is enough
            # and the step far too long once per rate model
            seeded = ion == "mfion" and k == 1 and not n_diff
            runs = [(1.0e3, None)]
            if seeded:
                runs.append((1.0e3, ref))
            if ion is not None and k == 1 and not n_diff:
                runs.append((1.0e9, None))
            for dt, f0 in runs:
                stats = torch.zeros(2, dtype=torch.int32, device=device)
                got_u = fm.update(mp, omx, E, nH, dt, rt, f0=f0, stats=stats)
                *ref_u, ref_stats = fm.update_plain(mp, omx, E, nH, dt, rt,
                                                    f0=f0, return_stats=True)
                torch.cuda.synchronize()
                tol = UPDATE_TOL[dtype]
                what = (f"({dtype} ion={ion} K={k} uv={n_diff} dt={dt:g} "
                        f"f0={f0 is not None})")
                for g, r in zip(got_u, ref_u):
                    if not bool(torch.isfinite(g).all()):
                        raise AssertionError(f"mpv3 update not finite {what}")
                    sc = torch.clamp(r.abs(), min=float(r.abs().max()) * 1e-6)
                    rel = ((g - r).abs() / sc).reshape(-1)
                    if dt < 1.0e9:
                        err = float(rel.max())
                        if not err <= tol:
                            raise AssertionError(
                                f"mpv3 update disagrees with its plain "
                                f"version: {err:.3e} > {tol:.1e} {what}")
                        wu = max(wu, err)
                        continue
                    share = float((rel > tol).float().mean())
                    med = float(rel.median())
                    if not med <= STIFF_MEDIAN or (
                            dtype == torch.float64
                            and not share <= STIFF_SHARE):
                        raise AssertionError(
                            f"mpv3 update at a stiff step: median {med:.3e}, "
                            f"share beyond {tol:.0e}: {share:.3f} {what}")
                    ws = max(ws, share if dtype == torch.float64 else med)
                tiles = stats.tolist()
                if not ladder_agrees(tiles[0], ref_stats[0]) or tiles[0] == 0:
                    raise AssertionError(
                        f"ladder ran on {tiles[0]} tiles in the kernel, "
                        f"{ref_stats[0]} in the plain version {what}")
                ladder.append(tiles + list(ref_stats))
            ncase += 1
        # update_stiff: share of cells beyond tol (float64), median (float32)
        worst[str(dtype).split(".")[-1]] = {"ydot": wy, "update": wu,
                                            "update_stiff": ws}
    ntile = -(-int(np.prod(shape)) // fm.TILE)
    return worst, ncase, {"tiles": ntile,
                          "ladder_tiles_min": min(r[0] for r in ladder),
                          "ladder_tiles_max": max(r[0] for r in ladder),
                          "newton_iterations_kernel_vs_plain":
                              [sum(r[1] for r in ladder),
                               sum(r[3] for r in ladder)]}


TRACE_CASES = [
    ((16, 16, 16), (8, 8, 8)),
    ((16, 12, 20), (4, 7, 9)),
    ((8, 8, 8), (0, 0, 0)),        # corner source
    ((8, 8, 8), (7, 1, 4)),        # boundary, strongly off-centre
    ((1, 12, 20), (0, 3, 14)),     # a 2D grid as a slab
]


def check_trace(device, big: bool):
    """B5 against its plain version: float32 and float64, centred, off-centre,
    corner and boundary sources, a slab, and (``big``) 128^3 with the source
    at the centre and in a corner."""
    from pion_tpu_torch.raytracing import fused_trace as ft

    cases = list(TRACE_CASES)
    if big:
        cases += [((128, 128, 128), (64, 64, 64)), ((128, 128, 128), (0, 0, 0))]
    worst = {}
    for dtype in (torch.float64, torch.float32):
        w = 0.0
        for i, (shape, src) in enumerate(cases):
            rng = np.random.default_rng(60 + i)
            dtau = torch.as_tensor(rng.uniform(0.01, 0.5, shape), dtype=dtype,
                                   device=device)
            tmin = 0.7 * 6.0 / 7.0
            got = ft.octant_trace(dtau, src, tmin)
            ref = ft.octant_trace_plain(dtau, src, tmin)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max() / ref.abs().max())
            if not (err <= TRACE_TOL[dtype]
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(
                    f"octant_trace disagrees with its plain version: "
                    f"{err:.3e} > {TRACE_TOL[dtype]:.1e} ({dtype} "
                    f"shape={shape} source={src})")
            w = max(w, err)
        worst[str(dtype).split(".")[-1]] = w
    return worst, len(cases) * 2


def hii_problem(n: int, dtype: str, kernels: str = "auto"):
    """The photoionised H II region: an O star (1e48 ionizing photons a
    second, 37500 K) at the centre of a uniform magnetised medium, nH = 100,
    300 K, on an n^3 grid 6e18 cm wide.  Returns (cfg, P0, make_physics)."""
    from pion_tpu_torch import SimConfig
    from pion_tpu_torch.constants import BX, K_B, PG, RO, RSUN
    from pion_tpu_torch.microphysics import MPv3, MPv3Config
    from pion_tpu_torch.physics import Physics
    from pion_tpu_torch.raytracing import Source

    cfg = SimConfig(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                    shape=(n,) * 3, xmin=(0.0,) * 3, xmax=(6.0e18,) * 3,
                    bcs=(("outflow", "outflow"),) * 3, cfl=0.3, ooa=2,
                    av="falle", etav=0.1, dtype=dtype, min_temperature=50.0,
                    max_temperature=1.0e9, tmax=1.0e16, kernels=kernels)
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mfion",
                     n_idot=1.0e48, tstar=3.75e4, rstar_cm=10 * RSUN,
                     min_temperature=50.0)

    def make_physics():
        return Physics(mp=MPv3(mpc), dt_limit=True, sources=[Source(
            position=(3.0e18,) * 3, strength=1.0e48, effect="mfion")])

    nH = 100.0
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 300.0
    P0[BX] = 4.0e-6 / np.sqrt(4.0 * np.pi)
    P0[cfg.eqn.nbase] = 1.0e-6
    return cfg, P0, make_physics


def mp_front_state(device, sim, P0, radius_cells: float):
    """B3 on a state with an ionization front: kernel against plain, tiles
    that take the ladder, time and bound."""
    from pion_tpu_torch.constants import K_B, PG
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    cfg, phys, mp = sim.cfg, sim.physics, sim.physics.mp
    c = mp.mpc
    n = cfg.shape[0]
    ax = np.arange(n) - (n - 1) / 2.0
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                + ax[None, None, :] ** 2)
    P = np.array(P0)
    inside = r < radius_cells
    xs = cfg.eqn.nbase
    P[xs][inside] = 0.999
    nH = P0[0] / c.mean_mass_per_h
    P[PG][inside] = ((c.n_ion + c.n_elec * 0.999) * nH * K_B * 8000.0)[inside]
    P = torch.as_tensor(P, dtype=sim.P.dtype, device=device)
    rt = phys.raytrace(P)
    omx, E, nH_t = mp.local_state(P)
    dt = float(sim.fns.calc_dt(P))
    stats = torch.zeros(2, dtype=torch.int32, device=device)
    got = fm.update(mp, omx, E, nH_t, dt, rt, stats=stats)
    *ref, ref_stats = fm.update_plain(mp, omx, E, nH_t, dt, rt,
                                      return_stats=True)
    torch.cuda.synchronize()
    tiles, newton = stats.tolist()
    err = max(soft_err(g, r_) for g, r_ in zip(got, ref))
    if not err <= UPDATE_TOL[P.dtype]:
        raise AssertionError(f"mpv3 update on the front state: {err:.3e} > "
                             f"{UPDATE_TOL[P.dtype]:.1e}")
    if tiles < 2 or not ladder_agrees(tiles, ref_stats[0]):
        raise AssertionError(f"front state ladder tiles: kernel {tiles}, "
                             f"plain {ref_stats[0]}")
    cells = omx.numel()
    esz = P.element_size()
    fy = fm.flops_per_ydot(mp, 1)
    tab_bytes = (mp.tab["t1_rows"].size + mp.tab["tau_rows"].size) * esz
    flops = cells * (fy + 12) + newton * fm.TILE * (3 * fy + 40)
    b_ms, b_by = bound(8 * cells * esz + tab_bytes + esz, flops, P.dtype)
    return {"dt": dt, "ladder_tiles": tiles, "newton_iterations": newton,
            "newton_iterations_plain": ref_stats[1], "max_soft_rel_err": err,
            "ms": time_ms(lambda: fm.update(mp, omx, E, nH_t, dt, rt), 20),
            "bound_ms": b_ms, "bound_by": b_by}


def grouped_err(out: torch.Tensor, ref: torch.Tensor, groups) -> float:
    """max over groups of variables of max|out-ref| / max|ref| within the
    group: for a state in which one component of a vector has next to no
    signal of its own (a field along x only)."""
    worst = 0.0
    tiny = torch.finfo(out.dtype).tiny
    for g in groups:
        diff = float((out[g] - ref[g]).abs().max())
        worst = max(worst, diff / max(float(ref[g].abs().max()), tiny))
    return worst


def measure_hii_sweep(device, sim):
    """B1 as the H II path launches it: all three axes, orders 1 and 2, the
    tracer clamp of a run with microphysics (``scma``), cgs units, the
    fallback mask — held against its plain version at 128^3 float32 and
    timed over that mix.  Two states: the run's own (errors scaled by
    groups of variables: mass, momentum, energy, field, psi, tracer), and
    the run's with seeded noise of 10 % of the sound speed on the velocities
    and of 10 % of the field on B and psi, so that every variable has a
    signal of its own (errors scaled variable by variable; that state also
    goes through the float64 instantiation).  With less noise float32 itself
    gives out at order 2 — the cleaning speed of this run is 2e15 cm/s, and
    both float32 versions then stand 0.1 to 0.5 from the float64 result —
    and the two differ by more than TOL without either being wrong."""
    from pion_tpu_torch.boundaries import apply_bcs
    from pion_tpu_torch.grid import make_geometry
    from pion_tpu_torch.constants import BX, PG, RO, SI, VX
    from pion_tpu_torch.ops import fused_sweep as fs
    from pion_tpu_torch.ops.sweep import hlld_fallback_cells
    from pion_tpu_torch.stepper import _scma_flag

    cfg, geom = sim.cfg, sim.geom
    scma = _scma_flag(sim.physics)
    if scma is not True:
        raise AssertionError(f"the H II run's sweep flag is {scma!r}")
    P = sim.P
    dt = sim.fns.calc_dt(P)
    ch = cfg.cfl * geom.dx / dt
    tol = TOL[P.dtype]
    nb = cfg.eqn.nbase
    groups = [[RO], [VX, VX + 1, VX + 2], [PG], [BX, BX + 1, BX + 2], [SI],
              list(range(nb, cfg.nvar))]
    rng = np.random.default_rng(11)
    cs = float(torch.sqrt(cfg.gamma * P[PG] / P[RO]).max())
    b0 = float(P[BX:BX + 3].abs().max())
    noisy = P.clone()
    noisy[VX:VX + 3] += torch.as_tensor(
        0.1 * cs * rng.standard_normal((3,) + cfg.shape), dtype=P.dtype,
        device=device)
    noisy[BX:SI + 1] += torch.as_tensor(
        0.1 * b0 * rng.standard_normal((4,) + cfg.shape), dtype=P.dtype,
        device=device)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    geom64 = make_geometry(cfg64)

    rec = {"scma": True, "axes": [0, 1, 2], "orders": [1, 2]}
    ms, plain_ms, by_case = [], [], {}
    abs_err = 0.0
    for label, state in (("run_state", P), ("noisy_state", noisy)):
        Ppad = apply_bcs(state, cfg).contiguous()
        strong = hlld_fallback_cells(Ppad, cfg, geom.dx)
        worst = worst64 = 0.0
        for axis in range(cfg.ndim):
            for order in (1, 2):
                if label == "noisy_state":
                    args = (Ppad.double(), cfg64, geom64, axis, order,
                            dt.double())
                    rel = scaled_err(
                        fs.sweep_axis(*args, ch=ch.double(), scma=scma,
                                      strong=strong),
                        fs.sweep_axis_plain(*args, ch=ch.double(),
                                            scma=scma))[0]
                    if not rel <= TOL[torch.float64]:
                        raise AssertionError(
                            f"sweep_axis on the H II path (float64) "
                            f"axis={axis} order={order}: {rel:.3e} > "
                            f"{TOL[torch.float64]:.1e}")
                    worst64 = max(worst64, rel)

                def kern():
                    return fs.sweep_axis(Ppad, cfg, geom, axis, order, dt,
                                         ch=ch, scma=scma, strong=strong)

                def plain():
                    return fs.sweep_axis_plain(Ppad, cfg, geom, axis, order,
                                               dt, ch=ch, scma=scma)

                out, ref = kern(), plain()
                if label == "run_state":
                    rel = grouped_err(out, ref, groups)
                else:
                    rel = scaled_err(out, ref)[0]
                if not rel <= tol:
                    raise AssertionError(
                        f"sweep_axis on the H II path ({label}) axis={axis} "
                        f"order={order} scma={scma}: {rel:.3e} > {tol:.1e}")
                worst = max(worst, rel)
                if label == "run_state":
                    abs_err = max(abs_err, float((out - ref).abs().max()))
                    k_ms = time_ms(kern, 20)
                    ms.append(k_ms)
                    plain_ms.append(time_ms(plain, 2, warmup=1))
                    by_case[f"axis{axis}_order{order}"] = k_ms
        rec[f"max_rel_err_{label}"] = worst
    rec["max_rel_err_noisy_state_f64"] = worst64
    cells = int(np.prod(cfg.shape))
    esz = P.element_size()
    n_if = cells // cfg.shape[0] * (cfg.shape[0] + 1)
    b_ms, b_by = bound(
        Ppad.numel() * esz + strong.numel() + 2 * esz + cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2, P.dtype)
    rec.update(launches=None, max_abs_err=abs_err, ms=float(np.mean(ms)),
               plain_ms=float(np.mean(plain_ms)), bound_ms=b_ms,
               bound_by=b_by, library_ms=None, ms_by_case=by_case)
    return rec


def measure_physics_kernels(device, n: int = 128, steps: int = 6):
    """B3, B4 and B5 at the shapes the H II path gives them (128^3, float32,
    one source): held against their plain versions on the state of a short
    run, then timed beside them.  B3 is timed twice: on the initial state
    with the source's column shut off and a short step (Euler only), and on
    the run's state with the step the run would take (with the ladder).
    Returns the three rows and the record of B1 on this path."""
    from pion_tpu_torch import Simulation
    from pion_tpu_torch.microphysics import fused_mpv3 as fm
    from pion_tpu_torch.raytracing import fused_trace as ft

    cfg, P0, make_physics = hii_problem(n, "float32")
    sim = Simulation(cfg, P0, physics=make_physics())
    sim.run(max_steps=steps)
    phys, mp = sim.physics, sim.physics.mp
    P = sim.P
    dtype = P.dtype
    esz = P.element_size()
    cells = P[0].numel()
    plane = cells * esz
    rt = phys.raytrace(P)
    omx, E, nH = mp.local_state(P)
    dt = float(sim.fns.calc_dt(P))
    fy = fm.flops_per_ydot(mp, 1)
    tab_bytes = (mp.tab["t1_rows"].size + mp.tab["tau_rows"].size) * esz
    rows = []

    # --- B4 ydot
    got, ref = fm.ydot(mp, omx, E, nH, rt), fm.ydot_plain(mp, omx, E, nH, rt)
    errs = [soft_err(g, r) for g, r in zip(got, ref)]
    for e, tol in zip(errs, YDOT_TOL[dtype]):
        if not e <= tol:
            raise AssertionError(f"mpv3 ydot at {n}^3: {e:.3e} > {tol:.1e}")
    b_ms, b_by = bound(8 * plane + tab_bytes, cells * fy, dtype)
    rows.append({
        "name": "mpv3_ydot", "route": "cuda", "source": MP_SOURCE,
        "replaces": "pion_tpu/microphysics/pallas_mpv3.py:314",
        "launches": None,
        "max_abs_err": max(float((g - r).abs().max())
                           for g, r in zip(got, ref)),
        "max_soft_rel_err": max(errs),
        "ms": time_ms(lambda: fm.ydot(mp, omx, E, nH, rt), 20),
        "plain_ms": time_ms(lambda: fm.ydot_plain(mp, omx, E, nH, rt), 3,
                            warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # --- B3 update, on the run's state (with the ladder) and quiescent
    stats = torch.zeros(2, dtype=torch.int32, device=device)
    got = fm.update(mp, omx, E, nH, dt, rt, stats=stats)
    *ref, ref_stats = fm.update_plain(mp, omx, E, nH, dt, rt,
                                      return_stats=True)
    torch.cuda.synchronize()
    tiles, newton = stats.tolist()
    errs = [soft_err(g, r) for g, r in zip(got, ref)]
    if not max(errs) <= UPDATE_TOL[dtype]:
        raise AssertionError(f"mpv3 update at {n}^3: {max(errs):.3e} > "
                             f"{UPDATE_TOL[dtype]:.1e}")
    if not ladder_agrees(tiles, ref_stats[0]):
        raise AssertionError(f"ladder tiles: kernel {tiles}, plain "
                             f"{ref_stats[0]}")
    # what this state needs: one evaluation a cell, and value plus two
    # tangents and the 2x2 solve for every cell of a tile in a Newton
    # iteration
    flops = cells * (fy + 12) + newton * fm.TILE * (3 * fy + 40)
    b_ms, b_by = bound(8 * plane + tab_bytes + esz, flops, dtype)
    P00 = torch.as_tensor(P0, dtype=dtype, device=device)
    q_state = mp.local_state(P00)
    q_rt = mp.default_rt(P00)
    q_rt = {"tau0": q_rt["tau0"], "ds": q_rt["ds"], "sv": q_rt["sv"]}
    q_stats = torch.zeros(2, dtype=torch.int32, device=device)
    fm.update(mp, *q_state, 1.0e7, q_rt, stats=q_stats)
    if q_stats.tolist()[0] != 0:
        raise AssertionError("the quiescent state ran the ladder")
    # a developed H II region, which ten steps from a neutral medium do not
    # reach: a sphere of 24 cells' radius ionised and at 8000 K, the front
    # around it stiff, at the step this state would take
    front = mp_front_state(device, sim, P0, n * 3.0 / 16.0)
    rows.append({
        "name": "mpv3_update", "route": "cuda", "source": MP_SOURCE,
        "replaces": "pion_tpu/microphysics/pallas_mpv3.py:489",
        "launches": None,
        "max_abs_err": max(float((g - r).abs().max())
                           for g, r in zip(got, ref)),
        "max_soft_rel_err": max(errs),
        "ms": time_ms(lambda: fm.update(mp, omx, E, nH, dt, rt), 20),
        "plain_ms": time_ms(lambda: fm.update_plain(mp, omx, E, nH, dt, rt),
                            2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "dt": dt, "tiles": -(-cells // fm.TILE), "ladder_tiles": tiles,
        "newton_iterations": newton,
        "ms_quiescent": time_ms(
            lambda: fm.update(mp, *q_state, 1.0e7, q_rt), 20),
        "bound_ms_quiescent": bound(8 * plane + tab_bytes + esz,
                                    cells * (fy + 12), dtype)[0],
        "front": front})

    # --- B5 octant trace
    src = phys.sources[0]
    tr = phys.raytracer.point_tracers[0]
    dtau = phys.dtau_for(src, P, phys.raytracer.static_fields(0, P)[0])
    got = ft.octant_trace(dtau, tr.src_idx, tr.tau_min)
    ref = ft.octant_trace_plain(dtau, tr.src_idx, tr.tau_min)
    err = float((got - ref).abs().max() / ref.abs().max())
    if not err <= TRACE_TOL[dtype]:
        raise AssertionError(f"octant_trace at {n}^3: {err:.3e} > "
                             f"{TRACE_TOL[dtype]:.1e}")
    # 4 divisions, a 4-term weighted mean and the weights: ~40 a cell
    b_ms, b_by = bound(2 * plane, 40 * cells, dtype)
    rows.append({
        "name": "octant_trace", "route": "cuda", "source": TRACE_SOURCE,
        "replaces": "pion_tpu/raytracing/pallas_trace.py:229",
        "launches": None, "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": err,
        "ms": time_ms(lambda: ft.octant_trace(dtau, tr.src_idx, tr.tau_min),
                      20),
        "plain_ms": time_ms(
            lambda: ft.octant_trace_plain(dtau, tr.src_idx, tr.tau_min), 2,
            warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shells": tr.n_steps})
    return rows, measure_hii_sweep(device, sim)


# the port's kernels by name, then PyTorch's by kind
KERNEL_GROUPS = ("sweep_axis_kernel", "final_axis_kernel", "update_kernel",
                 "ydot_kernel", "octant_trace_kernel", "CatArrayBatchedCopy",
                 "elementwise_kernel", "reduce_kernel", "index")


def device_time_by_kernel(run, steps: int, top_n: int = 10):
    """Device time of ``run()`` summed by kernel name, per step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
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
    # names cut to 60 characters: instantiations that share the prefix add up
    short = {}
    for k, us in by_name.items():
        short[k[:60]] = short.get(k[:60], 0.0) + us
    top = sorted(short.items(), key=lambda kv: -kv[1])[:top_n]
    groups = {}
    for k, us in by_name.items():
        g = next((name for name in KERNEL_GROUPS if name in k), "other plain")
        groups[g] = groups.get(g, 0.0) + us
    return {
        "profiled_steps": steps,
        # null when the profiler saw no device activity
        "device_ms_per_step": dev_ms / steps if dev_ms > 0 else None,
        "top_device_ms_per_step": {k: v / 1.0e3 / steps for k, v in top},
        "device_ms_per_step_by_group": {
            k: v / 1.0e3 / steps
            for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
    }


def hii_path(device, n: int, steps: int, agree_tol: float):
    """The H II region as a user runs it: ``Simulation(cfg, P0,
    physics=Physics(...)).run(max_steps=N)``.  Returns the phase record and
    the launch counts of the counted run."""
    from pion_tpu_torch import Simulation
    from pion_tpu_torch.utils import conservation_totals

    cfg, P0, make_physics = hii_problem(n, "float32")
    cells = n ** 3
    xs = cfg.eqn.nbase

    Simulation(cfg, P0, physics=make_physics()).run(max_steps=2)   # warm-up

    sim = Simulation(cfg, P0, physics=make_physics())
    mass0 = conservation_totals(sim.P, cfg, sim.geom)["mass"]
    ion0 = float(sim.P[xs].double().sum())
    reset_counts()
    sec, peak = timed_run(sim, steps)
    counts = read_counts()

    if sim.step_count != steps or not sim.t > 0.0:
        raise AssertionError(f"run ended at step {sim.step_count}, t={sim.t}")
    if tuple(sim.P.shape) != (cfg.nvar,) + cfg.shape:
        raise AssertionError(f"state shape {tuple(sim.P.shape)}")
    if not bool(torch.isfinite(sim.P).all()):
        raise AssertionError("non-finite values in the state")
    want = {"sweep_axis": 6 * steps, "final_axis": 0,
            "mpv3_update": 2 * steps, "mpv3_ydot": steps,
            "octant_trace": 2 * steps}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    x = sim.P[xs]
    T = sim.physics.mp.temperature(sim.P, cfg)
    xr = (float(x.min()), float(x.max()))
    Tr = (float(T.min()), float(T.max()))
    if not (0.0 <= xr[0] and xr[1] <= 1.0):
        raise AssertionError(f"ionization fraction outside [0, 1]: {xr}")
    # float32 rounding of the clamp's own temperature
    if not (50.0 * (1 - 1e-5) <= Tr[0] and Tr[1] <= 1.0e9 * (1 + 1e-5)):
        raise AssertionError(f"temperature outside [50, 1e9]: {Tr}")
    mass1 = conservation_totals(sim.P, cfg, sim.geom)["mass"]
    mass_err = abs(mass1 - mass0) / abs(mass0)
    if not mass_err <= 1.0e-5:
        raise AssertionError(f"mass not conserved: relative change {mass_err}")
    # the ionised volume in cells: the sum of x over the grid
    ion1 = float(x.double().sum())
    if not ion1 > 1.01 * ion0:
        raise AssertionError(f"the ionised volume did not grow: {ion0} -> "
                             f"{ion1} cells")

    # two more steps through the kernels and through the plain path (gather
    # ydot, one ladder for the whole grid, plane-sweep trace)
    clock = dict(t=sim.t, step_count=sim.step_count, last_dt=sim.last_dt)
    a = Simulation(cfg, sim.P, physics=make_physics(), **clock)
    a.run(max_steps=steps + 2)
    cfg_off = dataclasses.replace(cfg, kernels="off")
    b = Simulation(cfg_off, sim.P, physics=make_physics(), **clock)
    sec_off, peak_off = timed_run(b, 2)
    rel, _ = scaled_err(a.P, b.P)
    if not rel <= agree_tol:
        raise AssertionError(f"kernel and plain paths disagree after 2 "
                             f"steps: {rel:.3e} > {agree_tol:.1e}")
    clock_diff = abs(a.t - b.t) / abs(b.t)
    if clock_diff > 1.0e-4:
        raise AssertionError(f"clocks disagree: {a.t} vs {b.t}")

    parts = device_time_by_kernel(
        lambda: a.run(max_steps=a.step_count + 5), 5)
    if parts["device_ms_per_step"] is not None:
        parts["device_idle_share"] = max(
            0.0, 1.0 - parts["device_ms_per_step"] * steps / sec / 1.0e3)
    rec = {
        "shape": [n] * 3, "dtype": "float32", "steps": steps, "t": sim.t,
        "last_dt": sim.last_dt, "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "mass_rel_change": mass_err, "x_range": xr, "T_range": Tr,
        "ionised_volume_cells": [ion0, ion1],
        "kernels_vs_plain_2_steps": rel, "clock_rel_diff": clock_diff,
        "steps_per_s": steps / sec, "cell_updates_per_s": cells * steps / sec,
        "peak_mem_bytes": peak,
        "plain_steps_per_s": 2 / sec_off,
        "plain_cell_updates_per_s": cells * 2 / sec_off,
        "plain_peak_mem_bytes": peak_off,
        "step_parts": parts,
    }
    return rec, counts


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
    want = {"sweep_axis": 4 * steps, "final_axis": 2 * steps,
            "mpv3_update": 0, "mpv3_ydot": 0, "octant_trace": 0}
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
    w_mp, n_mp, ladder = check_mpv3(device)
    emit("mpv3_checks", cases=n_mp, max_soft_rel_err=w_mp, ladder=ladder,
         tol={"ydot": {str(k).split(".")[-1]: v for k, v in YDOT_TOL.items()},
              "update": {str(k).split(".")[-1]: v
                         for k, v in UPDATE_TOL.items()},
              "update_stiff_share": STIFF_SHARE,
              "update_stiff_median": STIFF_MEDIAN})
    w_tr, n_tr = check_trace(device, big=not args.quick)
    emit("trace_checks", cases=n_tr, max_rel_err=w_tr,
         tol={str(k).split(".")[-1]: v for k, v in TRACE_TOL.items()})
    if args.quick:
        return 0

    rows = measure_kernels(device, worst)
    phys_rows, hii_sweep = measure_physics_kernels(device)
    rows += phys_rows
    # B1's top-level numbers are the blast path's mix (axes 1 and 2, no
    # tracer clamp); its numbers on the H II path's mix stand under "hii"
    rows[0]["hii"] = hii_sweep
    emit("kernels", kernels=rows)

    rec32, counts = main_path((128, 128, 128), "float32", steps=10,
                              agree_tol=1.0e-4, plain_steps=3)
    emit("main_path", **rec32)
    parts = step_parts(device, steps=5)
    if parts["device_ms_per_step"] is not None:
        # idle share of the device in the unprofiled run above
        parts["device_idle_share"] = max(
            0.0, 1.0 - parts["device_ms_per_step"] * rec32["steps_per_s"] / 1.0e3)
    emit("step_parts", **parts)
    rec64, _ = main_path((64, 64, 64), "float64", steps=3, agree_tol=1.0e-9,
                         plain_steps=2)
    emit("main_path_f64", **rec64)
    # float32: the kernels against the plain path over two steps.  In this
    # early phase (dt ~10 s, at most a tile or two of 2048 past the Euler
    # cutoff, two substeps either way) the two ladders take the same steps, so
    # the paths differ by rounding only (read: 8e-8)
    rec_hii, counts_hii = hii_path(device, 128, steps=10, agree_tol=1.0e-5)
    emit("hii_path", **rec_hii)

    # launches on the main paths: each kernel's count from the run of the
    # path its numbers were measured for (B1 and B2: the blast wave, and B1
    # again under "hii"; the rest: the H II run)
    for row in rows:
        name = row["name"]
        blast = name in ("sweep_axis", "final_axis")
        row["launches"] = counts[name] if blast else counts_hii[name]
        row["launches_by_path"] = {"blast": counts[name],
                                   "hii": counts_hii[name]}
        if row["launches"] < 1:
            raise AssertionError(f"{name} was not launched on its main path")
    hii_sweep["launches"] = counts_hii["sweep_axis"]
    if hii_sweep["launches"] < 1:
        raise AssertionError("sweep_axis was not launched on the H II path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
