#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as described below
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes only

Needs one CUDA device and ``nvcc``; there is no CPU mode.  It builds the CUDA
kernels of ``pion_tpu_torch/csrc`` from source, holds each kernel against its
plain PyTorch version on the card, then drives the port's main paths at
128^3 in float32 — the 3D GLM-MHD blast wave (and from its state the MHD
linear and Roe solvers), the 3D Euler blast (HLL, then linear, Roe-CV and
Roe-PV), the photoionised H II region around an O star (MPv3 chemistry,
point-source raytrace, GLM-MHD) and the photoionised Euler wind bubble
(MPv3, a point source and a stellar wind) through ``Simulation.run``, and
the coupled flagship (a 2-level nested grid with that H II region and a
magnetised stellar wind) through ``NGHierarchy.step`` — and checks that each
run went through its kernels and that what came out is right.  Then each path again through ``run(chunk=k)``, k steps as one CUDA
graph replay: bit for bit the run of k single steps, and timed beside it.
Every phase prints one JSON line; any failed
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
# B1/B2 with the MHD linear and Roe solvers on the seeded noisy states: their
# wave decompositions divide by a^2 and cf^2 - cs^2 and sum seven waves'
# terms that cancel, and the linear solver's star state jumps where a wave
# speed changes sign, so a last-bit difference at the input (the kernels'
# reconstruction divides by dx, the plain one by the centre-of-volume
# spacing) can come out ~1e4 times larger, or as a jump.  In float64 the
# kernels stand 1e-12 from the plain version.  In float32 the plain version
# itself stands up to 0.2 from its own float64 on the 128^3 noisy blast
# (two cells of 2.1M, read on the card), so there both float32 versions are
# held against the plain version in float64 on the same inputs
# (``held_conditioned``), cell by cell at TOL_MHD_WAVES.
TOL_MHD_WAVES = {torch.float64: 1.0e-10, torch.float32: 1.0e-3}
EULER_SOLVERS = ("hll", "linear", "roe", "roe_pv")
MHD_WAVE_SOLVERS = ("linear", "roe", "roe_pv")


def kernel_tol(cfg, dtype):
    """B1/B2 against their plain versions: TOL, or TOL_MHD_WAVES for the
    MHD linear and Roe variants."""
    if cfg.eqn.is_mhd and cfg.solver.value in MHD_WAVE_SOLVERS:
        return TOL_MHD_WAVES[dtype]
    return TOL[dtype]


def conditioned(cfg, dtype) -> bool:
    """Whether B1/B2 of ``cfg`` in ``dtype`` are held against the float64
    plain version (``held_conditioned``): the MHD linear and Roe variants in
    float32."""
    return (dtype == torch.float32 and cfg.eqn.is_mhd
            and cfg.solver.value in MHD_WAVE_SOLVERS)


def cell_errs(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|out - ref| / max|ref_v| of each variable, the max over variables
    of each cell."""
    nv = out.shape[0]
    scale = ref.abs().reshape(nv, -1).amax(dim=1).double()
    scale = scale.clamp(min=torch.finfo(out.dtype).tiny)
    d = (out.double() - ref.double()).abs()
    return (d / scale.reshape((nv,) + (1,) * (out.ndim - 1))).amax(dim=0)


def held_conditioned(out, ref32, ref64, tol: float) -> dict:
    """A float32 kernel of an ill-conditioned solver against the plain
    version in float64 on the same inputs, given how far the plain version
    in float32 stands from it: the kernel's largest cell error at most
    twice the plain float32 version's (or ``tol``), and no more cells
    beyond ``tol`` than twice the plain float32 version's, plus two.
    Raises otherwise; returns the numbers."""
    k, p = cell_errs(out, ref64), cell_errs(ref32, ref64)
    rec = {"kernel_vs_plain64": float(k.max()),
           "plain32_vs_plain64": float(p.max()),
           "kernel_vs_plain32": scaled_err(out, ref32)[0],
           "cells_beyond_tol": [int((k > tol).sum()), int((p > tol).sum())]}
    n_k, n_p = rec["cells_beyond_tol"]
    if not (rec["kernel_vs_plain64"] <= max(tol,
                                            2.0 * rec["plain32_vs_plain64"])
            and n_k <= 2 * n_p + 2):
        raise AssertionError(f"kernel against the float64 plain version: "
                             f"{rec}, tol {tol:.1e}")
    return rec


def variant(cfg) -> str:
    """A B1/B2 variant's name: equation system and solver (GLM counts as
    MHD: the same solver code)."""
    return f"{'euler' if cfg.eqn.value == 'euler' else 'mhd'}_{cfg.solver.value}"


_T_START = time.perf_counter()


def elapsed_s() -> float:
    """Seconds since the script began; every phase's record carries it, to
    show where the script's time goes."""
    return time.perf_counter() - _T_START


def main_cfg(shape, dtype, **kw):
    """Configuration 1 (GLM-MHD, HLLD, Falle AV, one tracer, outflow) on
    ``shape``; ``kw`` overrides any field (the Euler path: ``eqn``,
    ``solver``)."""
    from pion_tpu_torch import SimConfig

    n = shape[-1]
    fields = dict(ndim=len(shape), eqn="glm", solver="hlld", ntracer=1,
                  shape=tuple(shape), xmin=(0.0,) * len(shape),
                  xmax=tuple(s / n for s in shape),
                  bcs=(("outflow", "outflow"),) * len(shape), cfl=0.3,
                  ooa=2, av="falle", etav=0.1, dtype=dtype)
    fields.update(kw)
    return SimConfig(**fields)


def noisy_state(cfg, seed: int) -> np.ndarray:
    """Blast wave with seeded noise on velocities, field and psi and a
    non-constant tracer in [0, 1], so that viscosity, upwinding, the Powell
    and GLM sources and the fallback mask all have something to act on (an
    Euler state has no field)."""
    from pion_tpu_torch.constants import BX, VX
    from pion_tpu_torch.ics import blast_wave

    rng = np.random.default_rng(seed)
    P = blast_wave(cfg, B0=(0.1, 0.05, 0.02))
    P[VX:VX + 3] += 0.1 * rng.standard_normal((3,) + cfg.shape)
    if cfg.eqn.is_mhd:
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
    axis and both orders (an ill-conditioned variant in float32 against the
    float64 plain version, ``held_conditioned``).  Returns the worst scaled
    errors (b1, b2)."""
    from pion_tpu_torch.ops import fused_sweep as fs

    geom, P, Ppad, strong, dt, ch = kernel_inputs(cfg, seed, device)
    tol = kernel_tol(cfg, Ppad.dtype)
    cond = conditioned(cfg, Ppad.dtype)
    if cond:
        # the same inputs in float64 (see TOL_MHD_WAVES)
        c64 = dataclasses.replace(cfg, dtype="float64")
        P64, Ppad64, dt64, ch64 = (P.double(), Ppad.double(), dt.double(),
                                   ch.double())
    worst1 = worst2 = 0.0
    for order in (1, 2):
        contribs = []
        for axis in range(cfg.ndim):
            out = fs.sweep_axis(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                scma=scma, strong=strong)
            ref = fs.sweep_axis_plain(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                      scma=scma)
            torch.cuda.synchronize()
            if cond:
                rel = held_conditioned(out, ref, fs.sweep_axis_plain(
                    Ppad64, c64, geom, axis, order, dt64, ch=ch64,
                    scma=scma), tol)["kernel_vs_plain64"]
            else:
                rel, _ = scaled_err(out, ref)
            if not (cond or rel <= tol):
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
        if cond:
            rel = held_conditioned(out, ref, fs.final_axis_plain(
                P64, Ppad64, [c.double() for c in contribs], c64, geom,
                order, dt64, ch=ch64), tol)["kernel_vs_plain64"]
        else:
            rel, _ = scaled_err(out, ref)
        if not (cond or rel <= tol):
            raise AssertionError(
                f"final_axis disagrees with its plain version: {rel:.3e} > "
                f"{tol:.1e} ({cfg.dtype} {cfg.eqn.value} {cfg.solver.value} "
                f"av={cfg.av.value} shape={cfg.shape} order={order} "
                f"mask={strong is not None})")
        worst2 = max(worst2, rel)
    return worst1, worst2


def check_kernels(device):
    """The case matrix at shapes that are no multiple of the block size nor
    of B1's and B2's tile (15 cells along the sweep axis, 32 pencils
    across): small ones, ones whose every axis spans several tiles, and
    ones whose axis 0 (B2's) ends in a partial tile; 3D and 2D, both
    dtypes, GLM and MHD, HLLD with and without the mask, HLL, viscosity on
    and off, tracers and the sCMA variants.  On three of the shapes also
    every Euler solver (HLL, linear, Roe-CV, Roe-PV) and the MHD linear and
    Roe solvers (GLM and MHD, roe_pv too), viscosity, tracers and sCMA
    taken in turn.  Returns the worst errors by dtype, the case count, and
    the worst errors by dtype of each variant (``variant``)."""
    from pion_tpu_torch import SimConfig

    worst = {}
    by_variant = {}
    ncase = 0
    for dtype in ("float64", "float32"):
        cases = []
        for shape in ((12, 20, 36), (20, 36), (40, 70, 150), (70, 150),
                      (37, 40, 48), (37, 50)):
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
            wave_shapes = ((12, 20, 36), (37, 40, 48), (37, 50))
            if shape not in wave_shapes:
                continue
            # each variant with and without sCMA over the three shapes (B2
            # runs only without)
            si = wave_shapes.index(shape)
            for j, solver in enumerate(EULER_SOLVERS):
                m = (j + si) % 2
                cases.append((SimConfig(
                    eqn="euler", solver=solver, gamma=1.4,
                    av=("falle", "none")[m], ntracer=(1, 3)[m], **box),
                    (False, (6, 7))[m]))
            for j, solver in enumerate(MHD_WAVE_SOLVERS):
                m = (j + si) % 2
                cases.append((SimConfig(
                    eqn=("glm", "mhd")[m], solver=solver,
                    av=("falle", "none")[m], ntracer=(1, 2)[m], **box),
                    (False, True)[m]))
        w1 = w2 = 0.0
        for i, (cfg, scma) in enumerate(cases):
            a, b = check_case(cfg, 100 + i, device, scma=scma)
            ncase += 1
            if cfg.solver.value in ("hll", "hlld") and cfg.eqn.is_mhd:
                w1, w2 = max(w1, a), max(w2, b)
                continue
            v = by_variant.setdefault(variant(cfg), {}).setdefault(
                dtype, [0.0, 0.0])
            v[0], v[1] = max(v[0], a), max(v[1], b)
        worst[dtype] = (w1, w2)
    return worst, ncase, by_variant


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
    tb, to = bound_sides(nbytes, flops, dtype)
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_sides(nbytes: int, flops: int, dtype):
    """(bytes over the memory rate, operations over the peak rate), in ms."""
    return (nbytes / PEAK_BYTES_PER_S * 1.0e3,
            flops / PEAK_FLOPS[dtype] * 1.0e3)


def update_flops(mp, cells: int, newton: int) -> int:
    """Operations of one B3 call on a state whose ladder tiles took
    ``newton`` Newton iterations in all (``stats``): one ``ydot`` and the
    Euler step a cell, and for each Newton iteration of a tile, all 1024
    of its cells evaluate ``ydot`` with two tangents (about three times its
    operations) and solve the 2x2 system (40)."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    fy = fm.flops_per_ydot(mp, 1)
    return cells * (fy + 12) + newton * fm.TILE * (3 * fy + 40)


# The kernel times of the phases below are taken by these two helpers, which
# kernel_times.py also drives on the same states to compare two checkouts.
def sweep_mix_ms(Ppad, cfg, geom, axes, dt, ch, strong, scma=False) -> dict:
    """B1's time a launch on a path's mix: each of ``axes`` at orders 1 and
    2, keyed ``axis{a}_order{o}``."""
    from pion_tpu_torch.ops import fused_sweep as fs

    return {f"axis{a}_order{o}": time_ms(
        lambda: fs.sweep_axis(Ppad, cfg, geom, a, o, dt, ch=ch, scma=scma,
                              strong=strong), 20)
        for a in axes for o in (1, 2)}


def update_ms(mp, omx, E, nH, dt: float, rt, f0=None) -> float:
    """B3's time a call, the step handed over on the card (``device_scalar``)."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    dt_dev = device_scalar(dt, omx)
    return time_ms(lambda: fm.update(mp, omx, E, nH, dt_dev, rt, f0=f0), 20)


def update_stats(mp, omx, E, nH, dt, rt, f0=None):
    """One B3 call with its diagnostics: (result, ladder tiles, Newton
    iterations in all)."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    stats = torch.zeros(2, dtype=torch.int32, device=omx.device)
    got = fm.update(mp, omx, E, nH, dt, rt, f0=f0, stats=stats)
    tiles, newton = stats.tolist()
    return got, tiles, newton


def measure_b1_b2(cfg, device, b2: bool = True) -> dict:
    """B1 (and with ``b2`` B2) on the main path's mix of ``cfg`` at its
    shape, the seeded noisy blast state: held against the plain versions on
    the same inputs (an ill-conditioned variant in float32 against the
    float64 plain version too, ``held_conditioned``), then timed beside them
    -- B1 on axes 1 and 2 and B2 on axis 0, each at orders 1 (predictor)
    and 2 (corrector); times are means over that mix.  Bounds: each input
    read once, each output written once; the operations from
    ``flops_per_interface`` (and for B2 the update of each cell, 80
    operations for MHD, 40 for Euler).  Returns ``{"sweep_axis": rec,
    "final_axis": rec}``."""
    from pion_tpu_torch.ops import fused_sweep as fs

    geom, P, Ppad, strong, dt, ch = kernel_inputs(cfg, 7, device)
    cells = int(np.prod(cfg.shape))
    esz = Ppad.element_size()
    tol = kernel_tol(cfg, Ppad.dtype)
    cond = conditioned(cfg, Ppad.dtype)
    c64 = dataclasses.replace(cfg, dtype="float64")
    mask_bytes = strong.numel() if strong is not None else 0
    contribs = [fs.sweep_axis_plain(Ppad, cfg, geom, a, 2, dt, ch=ch)
                for a in (1, 2)]

    def held(name, case, out, ref, ref64_fn):
        rel, ab = scaled_err(out, ref)
        if cond:
            # see TOL_MHD_WAVES
            return rel, ab, held_conditioned(out, ref, ref64_fn(), tol)
        if not rel <= tol:
            raise AssertionError(f"{name} {variant(cfg)} at {cfg.shape} "
                                 f"{case}: {rel:.3e} > {tol:.1e}")
        return rel, ab, None

    def record(errs, ms_by_case, plain, nbytes, flops, against64, axis):
        b_ms, b_by = bound(nbytes, flops, Ppad.dtype)
        rec = {"ms": float(np.mean(list(ms_by_case.values()))),
               "ms_by_case": ms_by_case, "plain_ms": float(np.mean(plain)),
               "max_rel_err_f32_128": errs[0], "max_abs_err": errs[1],
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_ms_bytes_operations": bound_sides(nbytes, flops,
                                                        Ppad.dtype),
               "flops_per_interface": [fs.flops_per_interface(cfg, o)
                                       for o in (1, 2)],
               "plan": dict(fs.sweep_plan(cfg.shape, axis, cfg.nvar,
                                          cfg.eqn.nbase, esz, 2,
                                          strong is not None))}
        if against64:
            rec["against_plain_float64"] = against64
        return rec

    out = {}
    errs, plain, against64 = [0.0, 0.0], [], {}
    for axis in (1, 2):
        for order in (1, 2):
            def plain_fn():
                return fs.sweep_axis_plain(Ppad, cfg, geom, axis, order, dt,
                                           ch=ch)

            case = f"axis{axis}_order{order}"
            rel, ab, h = held("sweep_axis", case, fs.sweep_axis(
                Ppad, cfg, geom, axis, order, dt, ch=ch, strong=strong),
                plain_fn(), lambda: fs.sweep_axis_plain(
                    Ppad.double(), c64, geom, axis, order, dt.double(),
                    ch=ch.double()))
            if h:
                against64[case] = h
            errs = [max(errs[0], rel), max(errs[1], ab)]
            plain.append(time_ms(plain_fn, 1, warmup=1))
    n_if = cells // cfg.shape[1] * (cfg.shape[1] + 1)
    out["sweep_axis"] = record(
        errs, sweep_mix_ms(Ppad, cfg, geom, (1, 2), dt, ch, strong), plain,
        Ppad.numel() * esz + mask_bytes + 2 * esz + cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2, against64, 1)
    if not b2:
        return out
    errs, plain, against64, ms2 = [0.0, 0.0], [], {}, {}
    for order in (1, 2):
        def kern():
            return fs.final_axis(P, Ppad, contribs, cfg, geom, order, dt,
                                 ch=ch, strong=strong)

        def plain_fn():
            return fs.final_axis_plain(P, Ppad, contribs, cfg, geom, order,
                                       dt, ch=ch)

        case = f"order{order}"
        rel, ab, h = held("final_axis", case, kern(), plain_fn(),
                          lambda: fs.final_axis_plain(
                              P.double(), Ppad.double(),
                              [c.double() for c in contribs], c64, geom,
                              order, dt.double(), ch=ch.double()))
        if h:
            against64[case] = h
        errs = [max(errs[0], rel), max(errs[1], ab)]
        ms2[case] = time_ms(kern, 20)
        plain.append(time_ms(plain_fn, 1, warmup=1))
    n_if = cells // cfg.shape[0] * (cfg.shape[0] + 1)
    out["final_axis"] = record(
        errs, ms2, plain,
        Ppad.numel() * esz + mask_bytes + 2 * esz
        + (2 + len(contribs)) * cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2
        + (40 if cfg.eqn.value == "euler" else 80) * cells, against64, 0)
    return out


def measure_kernels(device, worst, shape=(128, 128, 128)):
    """B1 and B2 at the main path's shapes (128^3, nvar 10, float32):
    ``measure_b1_b2`` of configuration 1, as rows of the ``kernels`` line."""
    recs = measure_b1_b2(main_cfg(shape, "float32"), device)
    rows = []
    for i, (name, line) in enumerate((("sweep_axis", 510),
                                      ("final_axis", 639))):
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"pion_tpu/ops/pallas_sweep.py:{line}",
            "launches": None, "max_rel_err_f64": worst["float64"][i],
            "max_rel_err_f32": worst["float32"][i], "library_ms": None,
            **recs[name]})
    return rows


def measure_variants(device, shape=(128, 128, 128)):
    """``measure_b1_b2`` of B1 and B2 on the Euler blast for each Euler
    solver, and of B1 on configuration 1 with the MHD linear and Roe
    solvers, 128^3 float32.  Returns ``{variant: {"sweep_axis": {...},
    "final_axis": {...}}}``."""
    out = {}
    for kw in ([dict(eqn="euler", solver=s) for s in EULER_SOLVERS]
               + [dict(solver=s) for s in ("linear", "roe")]):
        cfg = main_cfg(shape, "float32", **kw)
        out[variant(cfg)] = measure_b1_b2(cfg, device,
                                          b2=cfg.eqn.value == "euler")
    return out


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


# launches a step of each path, by wrapper (the hierarchy's: NG_LAUNCHES)
BLAST_LAUNCHES = {"sweep_axis": 4, "final_axis": 2, "mpv3_update": 0,
                  "mpv3_ydot": 0, "octant_trace": 0}
HII_LAUNCHES = {"sweep_axis": 6, "final_axis": 0, "mpv3_update": 2,
                "mpv3_ydot": 1, "octant_trace": 2}


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


def newton_agrees(kernel_its: int, plain_its: int, dtype) -> bool:
    """Whether the kernel and its plain version took the same Newton
    iterations in all: equal in float64; in float32 at most two apart, for
    tiles whose largest correction lands within rounding of the stopping
    tolerance in one version and so stop an iteration apart.  Read on an
    H100 over every state that holds it: equal in float64, and in float32
    equal but for 7085 against 7084 on the 1270 ladder tiles of
    ``MP_EDGE_CASES`` "walk"."""
    return abs(kernel_its - plain_its) <= (0 if dtype == torch.float64
                                           else 2)


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
    fit in shared memory.  This is the script's longest phase: the plain
    ladder steps all tiles together, so each of its 24 runs costs the host up
    to 32 substeps of 8 Newton iterations whatever the grid's size."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    worst = {}
    ncase = n_seeded = 0
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
            # the caller's first evaluation (as the nested-grid step hands
            # the dt limit's ydot to each level's first predictor): once per
            # dtype and rate model; and the step far too long once per rate
            # model
            seeded = ion is not None and k == 1 and not n_diff
            runs = [(1.0e3, None)]
            if seeded:
                runs.append((1.0e3, ref))
            if ion is not None and k == 1 and not n_diff:
                runs.append((1.0e9, None))
            for dt, f0 in runs:
                n_seeded += f0 is not None
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
    return worst, ncase, {"tiles": ntile, "updates_with_f0": n_seeded,
                          "ladder_tiles_min": min(r[0] for r in ladder),
                          "ladder_tiles_max": max(r[0] for r in ladder),
                          "newton_iterations_kernel_vs_plain":
                              [sum(r[1] for r in ladder),
                               sum(r[3] for r in ladder)]}


def check_ydot_grid(device):
    """B4's grid against ``ydot_plain`` (YDOT_TOL) on the cases it meets,
    in float64 and float32: fewer cells than a tile; a count no multiple of
    4 or of a tile; an odd number of tiles, the last partial; seven sources
    with UV heating, whose tables (read in place by B4) would not fit in
    shared memory in float64."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    recs = {}
    for i, dtype in enumerate((torch.float64, torch.float32)):
        name = str(dtype).split(".")[-1]
        for j, (label, shape, ion, k, uv) in enumerate((
                ("under_a_tile", (7, 9, 11), "mfion", 1, 0),
                ("ragged", (5, 17, 31), "mono", 2, 1),
                ("odd_tiles", (531 * fm.TILE - 3,), "mfion", 1, 0),
                ("many_tables", (7, 33, 41), "mfion", 7, 1))):
            mp = make_mp(ion, n_diff=uv)
            omx, E, nH, rt = mp_inputs(mp, shape, k, dtype, device,
                                       120 + 10 * i + j)
            n = omx.numel()
            plan = fm.ydot_plan(n)
            tables = (11 * mp.mpc.n_table + (4 * k * mp._n_tau
                                             if ion == "mfion" else 0)) \
                * omx.element_size()
            point = {"under_a_tile": n < fm.TILE,
                     "ragged": n % 4 and n % fm.TILE and plan["tiles"] > 1,
                     "odd_tiles": plan["tiles"] % 2 == 1 and n % fm.TILE,
                     "many_tables": (tables > 48 * 1024)
                     == (dtype == torch.float64)}[label]
            if not point:
                raise AssertionError(f"ydot case {label} ({name}) misses its "
                                     f"point: {n} cells, plan {dict(plan)}")
            got = fm.ydot(mp, omx, E, nH, rt)
            ref = fm.ydot_plain(mp, omx, E, nH, rt)
            torch.cuda.synchronize()
            errs = [soft_err(g, r) for g, r in zip(got, ref)]
            for e, tol in zip(errs, YDOT_TOL[dtype]):
                if not e <= tol:
                    raise AssertionError(
                        f"mpv3 ydot, case {label} ({name}): {e:.3e} > "
                        f"{tol:.1e}")
            recs[f"{label}_{name}"] = {
                "cells": n, "ion": ion, "sources": k, "uv": uv,
                "tiles": plan["tiles"], "table_bytes": tables,
                "max_soft_rel_err": max(errs)}
    return recs


# B3's two-launch design at its edges, each in float64 and float32: (label,
# grid, rate model, sources, step, seeded with f0).  "walk": a grid whose tile
# count (1586, the last one partial) is no multiple of the cluster size nor of
# pass 2's grid (1056 clusters on an H100), 1270 of them on the ladder, so
# that clusters walk more than one listed tile; "euler": a step so short that
# no tile takes the ladder; "ladder": every tile takes it, with five sources
# (one past those kept in registers); "seeded5": five sources and the
# caller's first evaluation.  The steps of "walk" and "seeded5" (10 s) keep
# their ladders at two substeps, so that the plain ladder, which steps on the
# host, stays short.
MP_EDGE_CASES = [
    ("walk", (50, 160, 203), "mfion", 1, 10.0, False),
    ("euler", (7, 33, 41), "mfion", 1, 1.0e-6, False),
    ("ladder", (7, 33, 41), "mono", 5, 1.0e3, False),
    ("seeded5", (7, 33, 41), "mfion", 5, 10.0, True),
]


def check_mpv3_edges(device):
    """B3 against ``update_plain`` on MP_EDGE_CASES: the same limit as
    ``check_mpv3`` at this step (UPDATE_TOL), the same ladder tiles
    (``ladder_agrees``) and Newton iterations in all (``newton_agrees``),
    and each case's own point (clusters that walk, no ladder, every tile on
    it)."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    recs = {}
    for dtype in (torch.float64, torch.float32):
        for i, (label, shape, ion, k, dt, seeded) in enumerate(MP_EDGE_CASES):
            mp = make_mp(ion)
            omx, E, nH, rt = mp_inputs(mp, shape, k, dtype, device, 80 + i)
            f0 = fm.ydot_plain(mp, omx, E, nH, rt) if seeded else None
            got, tiles, newton = update_stats(mp, omx, E, nH, dt, rt, f0=f0)
            *ref, ref_stats = fm.update_plain(mp, omx, E, nH, dt, rt, f0=f0,
                                              return_stats=True)
            plan = fm.update_plan(omx.numel(), fm._sm_count(device.index or 0))
            what = f"mpv3 update, edge case {label} ({dtype})"
            if not all(bool(torch.isfinite(g).all()) for g in got):
                raise AssertionError(f"{what}: not finite")
            err = max(soft_err(g, r) for g, r in zip(got, ref))
            if not err <= UPDATE_TOL[dtype]:
                raise AssertionError(f"{what}: {err:.3e} > "
                                     f"{UPDATE_TOL[dtype]:.1e}")
            if not (ladder_agrees(tiles, ref_stats[0])
                    and newton_agrees(newton, ref_stats[1], dtype)):
                raise AssertionError(
                    f"{what}: ladder tiles / Newton iterations {tiles} / "
                    f"{newton} in the kernel, {ref_stats[0]} / "
                    f"{ref_stats[1]} in the plain version")
            point = {"walk": tiles > plan["ladder_clusters"]
                     and plan["tiles"] % plan["ladder_clusters"]
                     and plan["tiles"] % plan["cluster"]
                     and omx.numel() % fm.TILE,
                     "euler": tiles == 0,
                     "ladder": tiles == plan["tiles"],
                     "seeded5": tiles > 0}[label]
            if not point:
                raise AssertionError(f"{what}: {tiles} of {plan['tiles']} "
                                     f"tiles took the ladder on "
                                     f"{plan['ladder_clusters']} clusters")
            recs[f"{label}_{str(dtype).split('.')[-1]}"] = {
                "shape": list(shape), "ion": ion, "sources": k, "dt": dt,
                "f0": seeded, "max_soft_rel_err": err,
                "ladder_tiles": tiles, "tiles": plan["tiles"],
                "ladder_clusters": plan["ladder_clusters"],
                "newton_iterations_kernel_vs_plain": [newton, ref_stats[1]]}
    return recs


TRACE_CASES = [
    ((16, 16, 16), (8, 8, 8)),
    ((16, 12, 20), (4, 7, 9)),
    ((8, 8, 8), (0, 0, 0)),        # corner source
    ((8, 8, 8), (7, 1, 4)),        # boundary, strongly off-centre
    ((1, 12, 20), (0, 3, 14)),     # a 2D grid as a slab
    ((37, 40, 48), (5, 39, 20)),   # faces no multiple of a block's rows
    ((5, 9, 11), (0, 4, 5)),       # an octant one cell thick along z,
    ((5, 9, 11), (2, 8, 5)),       # ... along y,
    ((5, 9, 11), (2, 4, 0)),       # ... along x
    ((4, 4, 600), (2, 1, 0)),      # long thin grids
    ((600, 3, 5), (300, 1, 2)),
    ((1, 1, 1), (0, 0, 0)),
]

# (shape, source, dtype, the plan and cluster size trace_plan must choose,
# seed): the main paths' 128^3 with the source at the centre and in a
# corner, a float64 trace on the largest cluster, and an octant too large
# for any cluster's shared memory, which keeps the device-memory plan
BIG_TRACE_CASES = [
    ((128, 128, 128), (64, 64, 64), torch.float64, ("cluster", 8), 65),
    ((128, 128, 128), (0, 0, 0), torch.float64, ("cluster", 16), 66),
    ((128, 128, 128), (64, 64, 64), torch.float32, ("cluster", 8), 65),
    ((128, 128, 128), (0, 0, 0), torch.float32, ("cluster", 16), 66),
    ((170, 170, 170), (0, 0, 0), torch.float64, ("cluster", 16), 67),
    ((228, 228, 228), (0, 0, 0), torch.float64, ("global", 1), 68),
]


def check_trace(device, big: bool):
    """B5 against its plain version: float32 and float64, centred,
    off-centre, corner and boundary sources, octants one cell thick, long
    thin grids, a slab, and (``big``) ``BIG_TRACE_CASES``, each on the plan
    it names.  Returns the worst error by dtype, the case count and each
    big case's plan."""
    from pion_tpu_torch.raytracing import fused_trace as ft

    cases = [(shape, src, dtype, None, 60 + i)
             for dtype in (torch.float64, torch.float32)
             for i, (shape, src) in enumerate(TRACE_CASES)]
    if big:
        cases += BIG_TRACE_CASES
    worst, plans = {}, {}
    for shape, src, dtype, want, seed in cases:
        rng = np.random.default_rng(seed)
        dtau = torch.as_tensor(rng.uniform(0.01, 0.5, shape), dtype=dtype,
                               device=device)
        tmin = 0.7 * 6.0 / 7.0
        plan = ft.trace_plan(shape, src, dtau.element_size())
        if want is not None:
            if (plan["plan"], plan["cluster"]) != want:
                raise AssertionError(f"trace_plan{shape, src} {dtype}: "
                                     f"{dict(plan)}, expected {want}")
            plans[f"{shape}_{src}_{str(dtype)[6:]}"] = dict(plan)
        got = ft.octant_trace(dtau, src, tmin)
        ref = ft.octant_trace_plain(dtau, src, tmin)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max() / ref.abs().max())
        if not (err <= TRACE_TOL[dtype] and bool(torch.isfinite(got).all())):
            raise AssertionError(
                f"octant_trace disagrees with its plain version: "
                f"{err:.3e} > {TRACE_TOL[dtype]:.1e} ({dtype} "
                f"shape={shape} source={src} plan={dict(plan)})")
        key = str(dtype).split(".")[-1]
        worst[key] = max(worst.get(key, 0.0), err)
    return worst, len(cases), plans


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


def front_state(sim, P0, radius_cells: float) -> torch.Tensor:
    """A developed H II region, which ten steps from a neutral medium do not
    reach: the H II run's initial state ``P0`` with a sphere of
    ``radius_cells`` around the centre ionised and at 8000 K, the front
    around it stiff."""
    from pion_tpu_torch.constants import K_B, PG

    cfg, c = sim.cfg, sim.physics.mp.mpc
    n = cfg.shape[0]
    ax = np.arange(n) - (n - 1) / 2.0
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                + ax[None, None, :] ** 2)
    P = np.array(P0)
    inside = r < radius_cells
    P[cfg.eqn.nbase][inside] = 0.999
    nH = P0[0] / c.mean_mass_per_h
    P[PG][inside] = ((c.n_ion + c.n_elec * 0.999) * nH * K_B * 8000.0)[inside]
    return torch.as_tensor(P, dtype=sim.P.dtype, device=sim.P.device)


def mp_front_state(sim, P0, radius_cells: float):
    """B3 on ``front_state``, at the step that state would take: kernel
    against plain, tiles that take the ladder, Newton iterations, time and
    bound."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    mp = sim.physics.mp
    P = front_state(sim, P0, radius_cells)
    rt = sim.physics.raytrace(P)
    omx, E, nH_t = mp.local_state(P)
    dt = float(sim.fns.calc_dt(P))
    got, tiles, newton = update_stats(mp, omx, E, nH_t, dt, rt)
    *ref, ref_stats = fm.update_plain(mp, omx, E, nH_t, dt, rt,
                                      return_stats=True)
    err = max(soft_err(g, r_) for g, r_ in zip(got, ref))
    if not err <= UPDATE_TOL[P.dtype]:
        raise AssertionError(f"mpv3 update on the front state: {err:.3e} > "
                             f"{UPDATE_TOL[P.dtype]:.1e}")
    if (tiles < 2 or not ladder_agrees(tiles, ref_stats[0])
            or not newton_agrees(newton, ref_stats[1], P.dtype)):
        raise AssertionError(f"front state ladder tiles / Newton iterations: "
                             f"kernel {tiles} / {newton}, plain "
                             f"{ref_stats[0]} / {ref_stats[1]}")
    cells = omx.numel()
    esz = P.element_size()
    tab_bytes = (mp.tab["t1_rows"].size + mp.tab["tau_rows"].size) * esz
    nbytes = 8 * cells * esz + tab_bytes + esz
    flops = update_flops(mp, cells, newton)
    b_ms, b_by = bound(nbytes, flops, P.dtype)
    return {"dt": dt, "ladder_tiles": tiles, "newton_iterations": newton,
            "newton_iterations_plain": ref_stats[1], "max_soft_rel_err": err,
            "ms": update_ms(mp, omx, E, nH_t, dt, rt),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_bytes_operations": bound_sides(nbytes, flops, P.dtype)}


def device_scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A step as a 0-d tensor on the card, as the paths hand it to the
    kernels.  Timed calls take it: a Python number is copied to the card from
    pageable memory at every call, and that copy waits for the stream, so
    the events would time the host."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


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


def hii_sweep_inputs(sim, state):
    """What the H II path hands B1 for ``state``: (padded state, fallback
    mask, dt, cleaning speed, tracer clamp)."""
    from pion_tpu_torch.boundaries import apply_bcs
    from pion_tpu_torch.ops.sweep import hlld_fallback_cells
    from pion_tpu_torch.stepper import _scma_flag

    cfg, geom = sim.cfg, sim.geom
    dt = sim.fns.calc_dt(sim.P)
    Ppad = apply_bcs(state, cfg).contiguous()
    return (Ppad, hlld_fallback_cells(Ppad, cfg, geom.dx), dt,
            cfg.cfl * geom.dx / dt, _scma_flag(sim.physics))


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
    from pion_tpu_torch.grid import make_geometry
    from pion_tpu_torch.constants import BX, PG, RO, SI, VX
    from pion_tpu_torch.ops import fused_sweep as fs

    cfg, geom = sim.cfg, sim.geom
    P = sim.P
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
    plain_ms, by_case = [], {}
    abs_err = 0.0
    for label, state in (("run_state", P), ("noisy_state", noisy)):
        Ppad, strong, dt, ch, scma = hii_sweep_inputs(sim, state)
        if scma is not True:
            raise AssertionError(f"the H II run's sweep flag is {scma!r}")
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

                def plain():
                    return fs.sweep_axis_plain(Ppad, cfg, geom, axis, order,
                                               dt, ch=ch, scma=scma)

                out = fs.sweep_axis(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                    scma=scma, strong=strong)
                ref = plain()
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
                    plain_ms.append(time_ms(plain, 2, warmup=1))
        if label == "run_state":
            by_case = sweep_mix_ms(Ppad, cfg, geom, range(cfg.ndim), dt, ch,
                                   strong, scma=scma)
        rec[f"max_rel_err_{label}"] = worst
    rec["max_rel_err_noisy_state_f64"] = worst64
    cells = int(np.prod(cfg.shape))
    esz = P.element_size()
    n_if = cells // cfg.shape[0] * (cfg.shape[0] + 1)
    b_ms, b_by = bound(
        Ppad.numel() * esz + strong.numel() + 2 * esz + cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2, P.dtype)
    rec.update(launches=None, max_abs_err=abs_err,
               ms=float(np.mean(list(by_case.values()))),
               plain_ms=float(np.mean(plain_ms)), bound_ms=b_ms,
               bound_by=b_by, library_ms=None, ms_by_case=by_case)
    return rec


def hii_run(n: int, steps: int):
    """The H II region at ``n``^3 float32 after ``steps`` steps: (the
    simulation, its initial state)."""
    from pion_tpu_torch import Simulation

    cfg, P0, make_physics = hii_problem(n, "float32")
    sim = Simulation(cfg, P0, physics=make_physics())
    sim.run(max_steps=steps)
    return sim, P0


def quiescent_inputs(mp, P0, like):
    """B3's inputs on the H II run's initial state with the source's column
    shut off: no cell heats, so a long step stays on the Euler pass."""
    P00 = torch.as_tensor(P0, dtype=like.dtype, device=like.device)
    rt = mp.default_rt(P00)
    return mp.local_state(P00), {"tau0": rt["tau0"], "ds": rt["ds"],
                                 "sv": rt["sv"]}


def measure_physics_kernels(device, n: int = 128, steps: int = 6):
    """B3, B4 and B5 at the shapes the H II path gives them (128^3, float32,
    one source): held against their plain versions on the state of a short
    run, then timed beside them.  B3 is timed twice: on the initial state
    with the source's column shut off and a short step (Euler only), and on
    the run's state with the step the run would take (with the ladder).
    Returns the three rows and the record of B1 on this path."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm
    from pion_tpu_torch.raytracing import fused_trace as ft

    sim, P0 = hii_run(n, steps)
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
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "plan": dict(fm.ydot_plan(cells))})

    # --- B3 update, on the run's state (with the ladder) and quiescent
    got, tiles, newton = update_stats(mp, omx, E, nH, dt, rt)
    *ref, ref_stats = fm.update_plain(mp, omx, E, nH, dt, rt,
                                      return_stats=True)
    errs = [soft_err(g, r) for g, r in zip(got, ref)]
    if not max(errs) <= UPDATE_TOL[dtype]:
        raise AssertionError(f"mpv3 update at {n}^3: {max(errs):.3e} > "
                             f"{UPDATE_TOL[dtype]:.1e}")
    if not (ladder_agrees(tiles, ref_stats[0])
            and newton_agrees(newton, ref_stats[1], dtype)):
        raise AssertionError(f"ladder tiles / Newton iterations: kernel "
                             f"{tiles} / {newton}, plain {ref_stats[0]} / "
                             f"{ref_stats[1]}")
    # what this state needs: one evaluation a cell, and value plus two
    # tangents and the 2x2 solve for every cell of a tile in a Newton
    # iteration
    flops = update_flops(mp, cells, newton)
    b_ms, b_by = bound(8 * plane + tab_bytes + esz, flops, dtype)
    q_state, q_rt = quiescent_inputs(mp, P0, P)
    if update_stats(mp, *q_state, 1.0e7, q_rt)[1] != 0:
        raise AssertionError("the quiescent state ran the ladder")
    # a developed H II region, a sphere of 24 cells' radius
    front = mp_front_state(sim, P0, n * 3.0 / 16.0)
    rows.append({
        "name": "mpv3_update", "route": "cuda", "source": MP_SOURCE,
        "replaces": "pion_tpu/microphysics/pallas_mpv3.py:489",
        "launches": None,
        "max_abs_err": max(float((g - r).abs().max())
                           for g, r in zip(got, ref)),
        "max_soft_rel_err": max(errs),
        "ms": update_ms(mp, omx, E, nH, dt, rt),
        "plain_ms": time_ms(lambda: fm.update_plain(mp, omx, E, nH, dt, rt),
                            2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "bound_ms_bytes_operations": bound_sides(8 * plane + tab_bytes + esz,
                                                 flops, dtype),
        "kernels": ["update_euler_kernel", "update_ladder_kernel"],
        "dt": dt, "tiles": -(-cells // fm.TILE), "ladder_tiles": tiles,
        "newton_iterations": newton,
        "plan": dict(fm.update_plan(cells, fm._sm_count(device.index or 0))),
        "ms_quiescent": update_ms(mp, *q_state, 1.0e7, q_rt),
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
        "shells": tr.n_steps, "source_cell": [int(v) for v in tr.src_idx],
        "plan": dict(ft.trace_plan(tuple(dtau.shape),
                                   tuple(int(v) for v in tr.src_idx), esz)),
        # the same column density from a source in a corner: one octant of
        # twice the shells
        "ms_corner": time_ms(lambda: ft.octant_trace(dtau, (0, 0, 0),
                                                     tr.tau_min), 20),
        "plan_corner": dict(ft.trace_plan(tuple(dtau.shape), (0, 0, 0), esz))})
    return rows, measure_hii_sweep(device, sim)


# the port's kernels by name, then PyTorch's by kind
KERNEL_GROUPS = ("sweep_axis_kernel", "final_axis_kernel",
                 "update_euler_kernel", "update_ladder_kernel",
                 "ydot_kernel", "octant_trace_cluster_kernel",
                 "octant_trace_global_kernel", "CatArrayBatchedCopy",
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
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
            n_kernels += e.count
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
        # every kernel and device copy, PyTorch's and the port's
        "device_launches_per_step": n_kernels / steps,
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
    want = {k: v * steps for k, v in HII_LAUNCHES.items()}
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


# ---------------------------------------------------------------------------
# the coupled flagship on a nested grid
# ---------------------------------------------------------------------------

# launches of one hierarchy step with 2 levels, one point source and the
# chemistry dt limit: three level-advances (level 0 once, level 1 twice).
# B1: 3 axes x (predictor + corrector) x 3.  B3: 2 x 3, two of them (the first
# predictor of each level) seeded with B4's output.  B4: once a level, for the
# dt limit.  B5: level 0 traces for the dt limit (shared with its predictor)
# and for its corrector; level 1 the same on its first substep, and for
# predictor and corrector on its second.
NG_LAUNCHES = {"sweep_axis": 18, "final_axis": 0, "mpv3_update": 6,
               "mpv3_ydot": 2, "octant_trace": 6}
NG_SEEDED = 2


def coupled_problem(n: int, dtype: str, kernels: str = "auto"):
    """The coupled flagship: the H II region of :func:`hii_problem` on a
    2-level nested grid of n^3 cells a level, with a magnetised stellar wind
    (1e-6 Msun/yr, 2000 km/s, 10 G at the surface) blown from the star's
    position inside a radius of six fine cells.  Returns (cfg, one state a
    level, make_physics)."""
    from pion_tpu_torch.constants import MSUN, YEAR
    from pion_tpu_torch.physics import Physics
    from pion_tpu_torch.winds import WindSource

    cfg1, P0, make_hii = hii_problem(n, dtype, kernels)
    cfg = dataclasses.replace(cfg1, nlevels=2)
    ctr = tuple(0.5 * (lo + hi) for lo, hi in zip(cfg.xmin, cfg.xmax))
    fine_dx = cfg.dx / 2

    def make_physics():
        hii = make_hii()
        return Physics(mp=hii.mp, sources=hii.sources, dt_limit=True,
                       wind_sources=[WindSource(
                           position=ctr, radius=6.0 * fine_dx,
                           mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8,
                           t_wind=3.0e4, b_star=10.0, tracers=(1.0,))])

    return cfg, [P0.copy(), P0.copy()], make_physics


def time_steps(hier, steps: int):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        hier.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def level_errs(a: torch.Tensor, b: torch.Tensor, dx_over_dt: float) -> dict:
    """max|a-b| / max|b| within each group of variables (mass, velocity,
    pressure, field, psi, tracer); psi, which holds next to nothing but
    rounding noise times the cleaning speed, is scaled by the field times
    dx/dt where that is larger."""
    from pion_tpu_torch.constants import BX, PG, RO, SI, VX

    groups = {"mass": [RO], "velocity": [VX, VX + 1, VX + 2],
              "pressure": [PG], "field": [BX, BX + 1, BX + 2],
              "tracer": list(range(SI + 1, a.shape[0]))}
    out = {k: grouped_err(a, b, [g]) for k, g in groups.items()}
    psi_scale = max(float(b[SI].abs().max()),
                    float(b[BX:BX + 3].abs().max()) * dx_over_dt)
    out["psi"] = float((a[SI] - b[SI]).abs().max()) / psi_scale
    return out


# What the chemistry update writes: pressure and the ionization fraction.
# There the kernel path and the plain path run two different integrators: the
# kernel (and ``update_plain``, which ``measure_ng_physics`` holds it
# against call by call on this very state) takes the substep count of its
# Newton ladder from each 1024-cell tile's stiffness, the plain path's
# ``MPv3._update_impl`` from the whole grid's.  After two hierarchy steps
# (two or four updates a level) these groups may stand as far apart as one
# call of the kernel may stand from its plain version (read: 5.5e-5 in the
# pressure of level 1, in the heated cells beside the wind region, which take
# the ladder at this run's dt of 300 to 1100 s; on that state one call of the
# kernel stands 2e-7 from ``update_plain``, and ``update_plain`` 2.7e-5
# from the whole-grid ladder, which ``measure_ng_physics`` prints).
CHEMISTRY_GROUPS = ("pressure", "tracer")


def clone_hierarchy(hier, cfg, physics):
    """A new hierarchy on ``hier``'s states and clock."""
    from pion_tpu_torch import NGHierarchy

    h = NGHierarchy(cfg, hier.n_levels, physics=physics)
    h.t, h.step_count, h.last_dt = hier.t, hier.step_count, hier.last_dt
    h.set_states(hier.P)
    return h


def ng_sweep_inputs(hier):
    """What the nested-grid path hands B1 on the fine level of ``hier``:
    (config, geometry, padded state, fallback mask, dt, cleaning speed,
    tracer clamp)."""
    from pion_tpu_torch.ops.sweep import hlld_fallback_cells
    from pion_tpu_torch.stepper import _scma_flag

    cfg, geom = hier.cfgs[1], hier.geoms[1]
    Ppad = hier._pad_level(1, hier.P[1], hier.P[0])
    dt = 0.5 * hier._level_dt(hier.P)
    return (cfg, geom, Ppad, hlld_fallback_cells(Ppad, cfg, geom.dx), dt,
            cfg.cfl * geom.dx / dt, _scma_flag(hier.phys[1]))


def ng_update_inputs(hier, level: int):
    """What the nested-grid path hands B3 on ``level`` of ``hier`` after its
    last step: (rate model, 1-x, E, nH, columns, the level's step)."""
    P, phys = hier.P[level], hier.phys[level]
    mp = phys.mp
    return (mp, *mp.local_state(P), phys.raytrace(P),
            hier.last_dt / 2 ** level)


def measure_ng_sweep(device, hier):
    """B1 as the nested-grid path launches it on the fine level: the padded
    state has prolonged ghosts instead of a domain boundary, the cell size is
    half the root's, and the wind region holds cells of rho = p = 1e-31 beside
    a 2000 km/s outflow.  All three axes, both orders, float32, 128^3:
    against the plain version (errors by groups of variables), and timed."""
    from pion_tpu_torch.constants import BX, PG, RO, SI, VX
    from pion_tpu_torch.ops import fused_sweep as fs

    cfg, geom, Ppad, strong, dt, ch, scma = ng_sweep_inputs(hier)
    nb = cfg.eqn.nbase
    groups = [[RO], [VX, VX + 1, VX + 2], [PG], [BX, BX + 1, BX + 2], [SI],
              list(range(nb, cfg.nvar))]
    tol = TOL[Ppad.dtype]
    worst = abs_err = 0.0
    plain_ms = []
    for axis in range(cfg.ndim):
        for order in (1, 2):
            def plain():
                return fs.sweep_axis_plain(Ppad, cfg, geom, axis, order, dt,
                                           ch=ch, scma=scma)

            out = fs.sweep_axis(Ppad, cfg, geom, axis, order, dt, ch=ch,
                                scma=scma, strong=strong)
            ref = plain()
            rel = grouped_err(out, ref, groups)
            if not rel <= tol:
                raise AssertionError(
                    f"sweep_axis on the nested-grid path axis={axis} "
                    f"order={order}: {rel:.3e} > {tol:.1e}")
            worst = max(worst, rel)
            abs_err = max(abs_err, float((out - ref).abs().max()))
            plain_ms.append(time_ms(plain, 2, warmup=1))
    by_case = sweep_mix_ms(Ppad, cfg, geom, range(cfg.ndim), dt, ch, strong,
                           scma=scma)
    cells = int(np.prod(cfg.shape))
    esz = Ppad.element_size()
    n_if = cells // cfg.shape[0] * (cfg.shape[0] + 1)
    b_ms, b_by = bound(
        Ppad.numel() * esz + strong.numel() + 2 * esz + cfg.nvar * cells * esz,
        n_if * (fs.flops_per_interface(cfg, 1)
                + fs.flops_per_interface(cfg, 2)) // 2, Ppad.dtype)
    return {"level": 1, "scma": True, "axes": [0, 1, 2], "orders": [1, 2],
            "dx_over_root_dx": 0.5, "max_rel_err": worst, "launches": None,
            "max_abs_err": abs_err,
            "ms": float(np.mean(list(by_case.values()))),
            "plain_ms": float(np.mean(plain_ms)), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "ms_by_case": by_case}


def measure_ng_physics(device, hier, timed: bool = True):
    """B4, B3 and B5 as the nested-grid path launches them, on both levels of
    the evolved coupled state: wind cells of rho = p = 1e-31 beside a
    2000 km/s outflow, the fine level's half cell size, the step the run just
    took (so the heated cells beside the wind region take the ladder), and
    B3 seeded with B4's output as each level's first predictor seeds it.
    Each against its plain version on the same inputs, at the limits of
    ``mpv3_checks`` and ``trace_checks``; timed (``timed``) on the fine
    level.  Returns one record a kernel."""
    from pion_tpu_torch.constants import PG
    from pion_tpu_torch.microphysics import fused_mpv3 as fm
    from pion_tpu_torch.raytracing import fused_trace as ft

    recs = {"mpv3_ydot": {}, "mpv3_update": {}, "octant_trace": {}}
    cfg_off = dataclasses.replace(hier.cfgs[0], kernels="off")
    for l in range(hier.n_levels):
        P, phys = hier.P[l], hier.phys[l]
        dtype = P.dtype
        what = f"on the nested-grid state, level {l} ({dtype})"
        # as the step's dt computation builds them
        mp, omx, E, nH, rt, dt = ng_update_inputs(hier, l)

        # --- B4
        f0 = fm.ydot(mp, omx, E, nH, rt)
        ref0 = fm.ydot_plain(mp, omx, E, nH, rt)
        errs = [soft_err(g, r) for g, r in zip(f0, ref0)]
        for e, tol in zip(errs, YDOT_TOL[dtype]):
            if not e <= tol:
                raise AssertionError(f"mpv3 ydot {what}: {e:.3e} > {tol:.1e}")
        recs["mpv3_ydot"][f"level{l}"] = {
            "max_soft_rel_err": max(errs),
            "max_abs_err": max(float((g - r).abs().max())
                               for g, r in zip(f0, ref0))}

        # --- B3: the predictor's half step seeded with the kernel's ydot,
        # the corrector's whole step unseeded
        up = {}
        for label, h, seed in (("predictor_seeded", 0.5 * dt, f0),
                               ("corrector", dt, None)):
            got, tiles, newton = update_stats(mp, omx, E, nH, h, rt, f0=seed)
            *ref, ref_stats = fm.update_plain(mp, omx, E, nH, h, rt, f0=seed,
                                              return_stats=True)
            err = max(soft_err(g, r) for g, r in zip(got, ref))
            if not (err <= UPDATE_TOL[dtype]
                    and all(bool(torch.isfinite(g).all()) for g in got)):
                raise AssertionError(f"mpv3 update {what}, {label}: "
                                     f"{err:.3e} > {UPDATE_TOL[dtype]:.1e}")
            if not (ladder_agrees(tiles, ref_stats[0])
                    and newton_agrees(newton, ref_stats[1], dtype)):
                raise AssertionError(
                    f"mpv3 update {what}, {label}: ladder tiles / Newton "
                    f"iterations {tiles} / {newton} in the kernel, "
                    f"{ref_stats[0]} / {ref_stats[1]} in the plain version")
            up[label] = {"dt": h, "max_soft_rel_err": err,
                         "max_abs_err": max(float((g - r).abs().max())
                                            for g, r in zip(got, ref)),
                         "ladder_tiles": tiles, "newton_iterations": newton,
                         "newton_iterations_plain": ref_stats[1]}
        # a reading, not a limit: how far the plain path's integrator (one
        # ladder for the whole grid) stands from the per-tile plain version
        # in one whole step on this state, in the pressure
        whole = mp._update_impl(P, dt, cfg_off, rt)
        tiled = mp._finish_update(P, nH, *ref)
        up["plain_per_tile_vs_plain_whole_grid_pressure"] = grouped_err(
            tiled, whole, [[PG]])
        recs["mpv3_update"][f"level{l}"] = up

        # --- B5
        tr = phys.raytracer.point_tracers[0]
        dtau = phys.dtau_for(phys.sources[0], P,
                             phys.raytracer.static_fields(0, P)[0])
        got_c = ft.octant_trace(dtau, tr.src_idx, tr.tau_min)
        ref_c = ft.octant_trace_plain(dtau, tr.src_idx, tr.tau_min)
        err = float((got_c - ref_c).abs().max() / ref_c.abs().max())
        if not (err <= TRACE_TOL[dtype]
                and bool(torch.isfinite(got_c).all())):
            raise AssertionError(f"octant_trace {what}: {err:.3e} > "
                                 f"{TRACE_TOL[dtype]:.1e}")
        recs["octant_trace"][f"level{l}"] = {
            "max_rel_err": err,
            "max_abs_err": float((got_c - ref_c).abs().max()),
            "source_cell": list(tr.src_idx), "shells": tr.n_steps}

    # the contract's keys, from the fine level (the loop's last)
    fine = f"level{hier.n_levels - 1}"
    esz = P.element_size()
    cells = omx.numel()
    plane = cells * esz
    fy = fm.flops_per_ydot(mp, 1)
    tab_bytes = (mp.tab["t1_rows"].size + mp.tab["tau_rows"].size) * esz
    newton = recs["mpv3_update"][fine]["corrector"]["newton_iterations"]
    bounds = {
        "mpv3_ydot": bound(8 * plane + tab_bytes, cells * fy, dtype),
        "mpv3_update": bound(8 * plane + tab_bytes + esz,
                             update_flops(mp, cells, newton), dtype),
        "octant_trace": bound(2 * plane, 40 * cells, dtype)}
    calls = {
        "mpv3_ydot": (lambda: time_ms(lambda: fm.ydot(mp, omx, E, nH, rt), 20),
                      lambda: fm.ydot_plain(mp, omx, E, nH, rt)),
        "mpv3_update": (lambda: update_ms(mp, omx, E, nH, dt, rt),
                        lambda: fm.update_plain(mp, omx, E, nH, dt, rt)),
        "octant_trace": (
            lambda: time_ms(
                lambda: ft.octant_trace(dtau, tr.src_idx, tr.tau_min), 20),
            lambda: ft.octant_trace_plain(dtau, tr.src_idx, tr.tau_min))}
    for name, rec in recs.items():
        levels = [rec[f"level{l}"] for l in range(hier.n_levels)]
        if name == "mpv3_update":
            levels = [v for lv in levels for v in lv.values()
                      if isinstance(v, dict)]
        rec.update(level=hier.n_levels - 1, shape=list(omx.shape),
                   launches=None,
                   max_abs_err=max(v["max_abs_err"] for v in levels),
                   bound_ms=bounds[name][0], bound_by=bounds[name][1],
                   library_ms=None)
        if timed:
            kern_ms, plain = calls[name]
            rec.update(ms=kern_ms(), plain_ms=time_ms(plain, 2, warmup=1))
    if timed:
        recs["mpv3_update"]["ms_predictor_seeded"] = update_ms(
            mp, omx, E, nH, 0.5 * dt, rt, f0=f0)
    return recs


def ng_glue_parts(hier):
    """The plain passes that the nested grid and the wind add to a step,
    each timed alone, with how often a 2-level hierarchy step runs it."""
    from pion_tpu_torch.ops.sweep import interface_flux_pair

    cfg, geom = hier.cfgs[1], hier.geoms[1]
    n = cfg.shape[0]
    P0, P1 = hier.P
    Ppad = hier._pad_level(1, P1, P0)
    dt = 0.5 * hier._level_dt(hier.P)
    ch = cfg.cfl * geom.dx / dt
    Fa, Fb = interface_flux_pair(Ppad, cfg, geom, 0, 0, n, dt, 2, ch=ch,
                                 scma=True)
    sums = [(hier._restrict_face_flux(Fa, ax, 1),
             hier._restrict_face_flux(Fb, ax, 1)) for ax in range(cfg.ndim)]
    dU = torch.zeros_like(P0)
    plane = Fa.new_zeros((cfg.nvar, n, n))
    wind = hier.phys[1].winds[0]
    calls = {
        # (the call, how often a 2-level hierarchy step makes it)
        "pad_level_1": (lambda: hier._pad_level(1, P1, P0), 4),
        "pad_level_0": (lambda: hier._pad_level(0, P0, None), 2),
        "restrict": (lambda: hier._restrict(P0, P1, 1), 1),
        "interface_flux_pair": (
            lambda: interface_flux_pair(Ppad, cfg, geom, 0, 0, n, dt, 2,
                                        ch=ch, scma=True), 9),
        "restrict_face_flux": (
            lambda: hier._restrict_face_flux(Fa, 0, 1), 12),
        "bc89_correct": (
            lambda: hier._bc89_correct(dU, lambda ax, i: plane, sums, 0, dt),
            1),
        "wind_apply": (lambda: wind.apply(P1, hier.t), 6),
    }
    # Two times a call.  ``ms``: CUDA events around ten calls queued behind a
    # busy device, so the larger of what the host needs to queue a call and
    # what the device needs to run it.  ``device_ms``: the profiler's sum
    # over the kernels the call launched, and their number.
    rec = {}
    for name, (fn, k) in calls.items():
        def ten():
            for _ in range(10):
                fn()

        prof = device_time_by_kernel(ten, 10)
        rec[name] = {"ms": time_ms(fn, 10), "calls_per_step": k,
                     "device_ms": prof["device_ms_per_step"],
                     "device_launches": prof["device_launches_per_step"]}
    glue = [v for name, v in rec.items() if name != "wind_apply"]
    out = {"per_call": rec,
           "ng_glue_ms_per_step": sum(v["ms"] * v["calls_per_step"]
                                      for v in glue),
           "wind_ms_per_step": rec["wind_apply"]["ms"] * 6}
    if all(v["device_ms"] is not None for v in glue):
        out["ng_glue_device_ms_per_step"] = sum(
            v["device_ms"] * v["calls_per_step"] for v in glue)
        out["ng_glue_device_launches_per_step"] = sum(
            v["device_launches"] * v["calls_per_step"] for v in glue)
    return out


def check_hierarchy(hier, what: str):
    """Finite on every level; x in [0, 1]; T in [50, 1e9] away from the wind
    (the free wind itself is colder by design: it cools adiabatically from
    the stellar surface, and its inner cells are inert at rho = p = 1e-31);
    the wind region of the finest level holds the free-wind state; the
    covered level-0 cells are the restriction of level 1."""
    xs = hier.cfg0.eqn.nbase
    out = {}
    for l in range(hier.n_levels):
        P, cfg, phys = hier.P[l], hier.cfgs[l], hier.phys[l]
        if tuple(P.shape) != (cfg.nvar,) + cfg.shape:
            raise AssertionError(f"{what}: level {l} shape {tuple(P.shape)}")
        if not bool(torch.isfinite(P).all()):
            raise AssertionError(f"{what}: non-finite values on level {l}")
        x = P[xs]
        xr = (float(x.min()), float(x.max()))
        if not (0.0 <= xr[0] and xr[1] <= 1.0):
            raise AssertionError(f"{what}: level {l} ionization fraction "
                                 f"outside [0, 1]: {xr}")
        w = phys.winds[0]
        far = w._fields(P)["dist"] > w.src.radius + 2.0 * cfg.dx
        T = phys.mp.temperature(P, cfg)[far]
        Tr = (float(T.min()), float(T.max()))
        # float32 rounding of the clamp's own temperature
        if not (50.0 * (1 - 1e-5) <= Tr[0] and Tr[1] <= 1.0e9 * (1 + 1e-5)):
            raise AssertionError(f"{what}: level {l} temperature outside "
                                 f"[50, 1e9]: {Tr}")
        out[f"level{l}"] = {"x_range": xr, "T_range": Tr}
    fine = hier.n_levels - 1
    w = hier.phys[fine].winds[0]
    m = w.mask_like(hier.P[fine])
    W = w.wind_state(hier.P[fine], hier.t)
    if not torch.equal(hier.P[fine][:, m], W[:, m]):
        raise AssertionError(f"{what}: the wind region of level {fine} does "
                             f"not hold the free-wind state")
    out["wind_cells"] = int(m.sum())
    # independent of what ``apply`` wrote from: rho r^2 = Mdot / (4 pi v_inf)
    # all over the free-wind shell (inside it the cells are inert)
    geo = w._fields(hier.P[fine])
    shell = m & ~geo["inner"]
    flow = (hier.P[fine][0].double() * geo["dist"].double() ** 2)[shell]
    flow = flow / (w.src.mdot / (4.0 * np.pi * w.src.vinf))
    dev = float((flow - 1.0).abs().max())
    if not (int(shell.sum()) > 0 and dev <= 1.0e-5):
        raise AssertionError(f"{what}: rho r^2 over the free-wind shell of "
                             f"level {fine} is off Mdot/(4 pi v_inf) by "
                             f"{dev:.3e}")
    out["free_wind_cells"] = int(shell.sum())
    out["free_wind_rho_r2_max_rel_dev"] = dev
    for l in range(fine):
        if not torch.equal(hier._restrict(hier.P[l], hier.P[l + 1], l + 1),
                           hier.P[l]):
            raise AssertionError(f"{what}: level {l} is not the restriction "
                                 f"of level {l + 1} where that covers it")
    return out


def ng_path(device, n: int, steps: int, agree_tol: float, dtype="float32"):
    """The coupled flagship as a user runs it: ``NGHierarchy(cfg, 2,
    physics=Physics(mp, sources, wind_sources, dt_limit=True))``,
    ``set_states``, ``step()``.  Returns the phase record, the launch counts
    of the counted steps, and the hierarchy."""
    from pion_tpu_torch import NGHierarchy
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    cfg, states, make_physics = coupled_problem(n, dtype)
    hier = NGHierarchy(cfg, 2, physics=make_physics())
    hier.set_states(states)
    for _ in range(2):          # warm-up; the first step is under the wind cap
        hier.step()
    reset_counts()
    fm.update.launches_seeded = 0
    sec, peak = time_steps(hier, steps)
    counts = read_counts()
    seeded = fm.update.launches_seeded
    if hier.step_count != steps + 2 or not hier.t > 0.0:
        raise AssertionError(f"ended at step {hier.step_count}, t={hier.t}")
    want = {k: v * steps for k, v in NG_LAUNCHES.items()}
    if counts != want or seeded != NG_SEEDED * steps:
        raise AssertionError(
            f"launch counts {counts} ({seeded} updates seeded), expected "
            f"{want} ({NG_SEEDED * steps} seeded)")
    ranges = check_hierarchy(hier, "ng_path")

    # Two more hierarchy steps from the evolved state through every kernel,
    # and through the plain path (``kernels="off"``: plain sweep with its own
    # faces, gather ydot, one Newton ladder for the whole grid, plane-sweep
    # trace).  Mass, velocity, field and psi are held to ``agree_tol``; the
    # two groups the chemistry writes to the kernel's own limit against its
    # plain version (see CHEMISTRY_GROUPS).
    a = clone_hierarchy(hier, cfg, make_physics())
    a.step()
    a.step()
    cfg_off = dataclasses.replace(cfg, kernels="off")
    b = clone_hierarchy(hier, cfg_off, make_physics())
    sec_off, peak_off = time_steps(b, 2)
    dxdt = [b.geoms[l].dx / (b.last_dt / 2 ** l) for l in range(2)]
    errs = [level_errs(a.P[l], b.P[l], dxdt[l]) for l in range(2)]
    clock_diff = abs(a.t - b.t) / abs(b.t)
    chem_tol = UPDATE_TOL[a.P[0].dtype]
    print(json.dumps({"phase": "ng_path.agreement", "dtype": dtype,
                      "kernels_vs_plain_by_level": errs,
                      "clock_rel_diff": clock_diff, "tol": agree_tol,
                      "tol_chemistry_groups": chem_tol,
                      "elapsed_s": elapsed_s()}), flush=True)
    for l in range(2):
        for group, err in errs[l].items():
            tol = chem_tol if group in CHEMISTRY_GROUPS else agree_tol
            if not err <= tol:
                raise AssertionError(
                    f"kernels against the plain path after 2 hierarchy "
                    f"steps, level {l}, {group}: {err:.3e} > {tol:.1e}")
    if clock_diff > 1.0e-4:
        raise AssertionError(f"clocks disagree: {clock_diff:.3e}")

    cells = 3 * n ** 3          # level 0 once, level 1 twice
    rec = {
        "shape": [n] * 3, "levels": 2, "dtype": dtype, "steps": steps,
        "t": hier.t, "last_dt": hier.last_dt, "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "updates_seeded_per_step": seeded / steps, "ranges": ranges,
        "kernels_vs_plain_2_steps_by_level": errs,
        "tol": agree_tol, "tol_chemistry_groups": chem_tol,
        "clock_rel_diff": clock_diff,
        "steps_per_s": steps / sec, "ms_per_step": sec / steps * 1.0e3,
        "cell_updates_per_s": cells * steps / sec, "peak_mem_bytes": peak,
        "plain_steps_per_s": 2 / sec_off,
        "plain_cell_updates_per_s": cells * 2 / sec_off,
        "plain_peak_mem_bytes": peak_off,
    }
    return rec, counts, hier


def ng_step_parts(hier, ms_per_step: float):
    """Where the hierarchy step's time goes: device time of three profiled
    steps summed by kernel name, the idle share of the device in the
    unprofiled run that took ``ms_per_step``, and the nested-grid and wind
    passes timed alone."""
    def three():
        for _ in range(3):
            hier.step()

    parts = device_time_by_kernel(three, 3)
    if parts["device_ms_per_step"] is not None:
        parts["device_idle_share"] = max(
            0.0, 1.0 - parts["device_ms_per_step"] / ms_per_step)
    parts.update(ng_glue_parts(hier))
    return parts


def ng_dynamics(device, n: int, steps: int, hier):
    """The same hierarchy without physics beside the coupled one
    (``hier``), timed in turns (dynamics, coupled, dynamics, coupled) for the
    coupled/dynamics ratio; and a blast wave across the coarse-fine interface
    on a hierarchy without physics, through the kernels and through the plain
    path, for what the flux correction keeps of the composite mass (the
    level-0 total after restriction)."""
    from pion_tpu_torch import NGHierarchy
    from pion_tpu_torch.ics import blast_wave
    from pion_tpu_torch.utils import conservation_totals

    cfg, states, _ = coupled_problem(n, "float32")
    dyn = NGHierarchy(cfg, 2)
    dyn.set_states(states)
    for _ in range(2):
        dyn.step()
    reset_counts()
    sec, peak = time_steps(dyn, steps)
    counts = read_counts()
    want = dict(NG_LAUNCHES, mpv3_update=0, mpv3_ydot=0, octant_trace=0)
    want = {k: v * steps for k, v in want.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    ms_dyn = [sec / steps * 1.0e3]
    ms_coupled = [time_steps(hier, steps)[0] / steps * 1.0e3]
    ms_dyn.append(time_steps(dyn, steps)[0] / steps * 1.0e3)
    ms_coupled.append(time_steps(hier, steps)[0] / steps * 1.0e3)
    for h in (dyn, hier):
        for l in range(2):
            if not bool(torch.isfinite(h.P[l]).all()):
                raise AssertionError(f"non-finite values on level {l}")
    sec = float(np.mean(ms_dyn)) * steps / 1.0e3

    # the blast: the pressure jump sits a cell inside the fine level's edge
    bsteps = 12
    drift, mass = {}, {}
    final = {}
    for kernels in ("auto", "off"):
        bcfg = dataclasses.replace(main_cfg((n,) * 3, "float32"), nlevels=2,
                                   kernels=kernels)
        h = NGHierarchy(bcfg, 2)
        h.set_states([blast_wave(c, r_in=0.25 - 1.5 * h.cfgs[1].dx,
                                 B0=(0.1, 0.05, 0.0)) for c in h.cfgs])
        h.P[0] = h._restrict(h.P[0], h.P[1], 1)
        m0 = conservation_totals(h.P[0], h.cfgs[0], h.geoms[0])["mass"]
        for _ in range(bsteps):
            h.step()
        m1 = conservation_totals(h.P[0], h.cfgs[0], h.geoms[0])["mass"]
        drift[kernels] = abs(m1 - m0) / abs(m0)
        mass[kernels] = m1
        final[kernels] = h
    # the shock has crossed the interface: the coarse cells outside it moved
    off = final["off"].offs[1][0]
    outside = final["off"].P[0][1][off - 1, n // 2, n // 2]
    if not float(outside) > 0.1 * 1.01:
        raise AssertionError("the blast did not reach the coarse-fine "
                             "interface")
    rels = [scaled_err(final["auto"].P[l], final["off"].P[l])[0]
            for l in range(2)]
    rec = {"shape": [n] * 3, "levels": 2, "dtype": "float32", "steps": steps,
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "steps_per_s": steps / sec, "ms_per_step": sec / steps * 1.0e3,
           "cell_updates_per_s": 3 * n ** 3 * steps / sec,
           "peak_mem_bytes": peak,
           "dynamics_ms_per_step_in_turns": ms_dyn,
           "coupled_ms_per_step_in_turns": ms_coupled,
           "coupled_over_dynamics": float(np.mean(ms_coupled)
                                          / np.mean(ms_dyn)),
           "blast": {"steps": bsteps, "composite_mass_rel_drift": drift,
                     "mass_kernels_vs_plain": abs(mass["auto"] - mass["off"])
                     / abs(mass["off"]),
                     "kernels_vs_plain_by_level": rels}}
    print(json.dumps({"phase": "ng_dynamics.blast", **rec["blast"],
                      "elapsed_s": elapsed_s()}), flush=True)
    if not max(drift.values()) <= 1.0e-5:
        raise AssertionError(f"composite mass not conserved: {drift}")
    if not max(rels) <= 1.0e-3:
        raise AssertionError(f"blast hierarchy: kernel and plain paths "
                             f"disagree after {bsteps} steps: {rels}")
    return rec


# ---------------------------------------------------------------------------
# several steps in one dispatch: run(chunk=k), one CUDA graph replay a chunk
# ---------------------------------------------------------------------------

def states_of(run):
    return run.P if isinstance(run.P, list) else [run.P]


def same_run(a, b, what: str) -> dict:
    """``a`` (chunked) against ``b`` (one step at a time): every state bit
    for bit, the same clock and step count; raises otherwise."""
    diff = max(float((x.double() - y.double()).abs().max())
               for x, y in zip(states_of(a), states_of(b)))
    same = all(torch.equal(x, y) for x, y in zip(states_of(a), states_of(b)))
    if not (same and a.t == b.t and a.step_count == b.step_count
            and a.last_dt == b.last_dt):
        raise AssertionError(
            f"{what}: run(chunk) differs from single steps: max |diff| "
            f"{diff:.3e}, t {a.t!r} vs {b.t!r}, steps {a.step_count} vs "
            f"{b.step_count}")
    for x in states_of(a):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: non-finite values")
    return {"max_abs_diff": diff, "t": a.t, "steps": a.step_count}


def sync_free(step, what: str):
    """One eager step (its caches already filled) under
    ``torch.cuda.set_sync_debug_mode("error")``: anything in it that waits
    for the card raises, naming the operation."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    except RuntimeError as err:
        raise AssertionError(f"{what}: the step waits for the card: "
                             f"{err}") from err
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def chunk_graph(run):
    """The one CUDA graph a run has recorded."""
    graphs = (run._graphs if hasattr(run, "_graphs")
              else run.fns.multi_step.graphs)
    if len(graphs) != 1:
        raise AssertionError(f"{len(graphs)} graphs recorded, expected 1")
    return next(iter(graphs.values()))


def chunk_case(make, what, per_step, first=0, **run):
    """``make()`` twice: one run with ``chunk``, one without, from the same
    state, compared bit for bit.  Before them, one eager step of a third
    under the sync check.  The chunked run's launches are counted: its
    ``first`` single steps, the graph's warm-up (one chunk, run for real)
    and one chunk a replay; the capture launches nothing."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    probe = make()
    if hasattr(probe, "_dt_and_advance"):
        def one():
            probe._dt_and_advance(list(probe.P), probe.t, probe.last_dt,
                                  probe._dt_cap(), probe._sources())
    else:
        def one():
            probe.fns.step(probe.P, probe.t, probe.last_dt, probe._dt_cap(),
                           probe._sources())
    one()
    sync_free(one, what)
    del probe
    a, b = make(), make()
    reset_counts()
    fm.update.launches_seeded = 0
    t0 = time.perf_counter()
    a.run(**run)
    sec = time.perf_counter() - t0
    counts = read_counts()
    seeded = fm.update.launches_seeded
    b.run(**{k: v for k, v in run.items() if k != "chunk"})
    rec = same_run(a, b, what)
    k = run["chunk"]
    # a replay runs all k steps of the body, the last chunk's dropped ones
    # too
    body = first + k * (1 + -(-(a.step_count - first) // k))
    want = {name: n * body for name, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected "
                             f"{want} ({a.step_count} steps, {first} alone, "
                             f"a warm-up chunk of {k})")
    if per_step is NG_LAUNCHES and seeded != NG_SEEDED * body:
        raise AssertionError(f"{what}: {seeded} updates seeded, expected "
                             f"{NG_SEEDED * body}")
    g = chunk_graph(a)
    rec.update(chunk=k, launches=counts, first_run_s=sec,
               capture_s=g.capture_s, graph_pool_bytes=g.pool_bytes)
    return rec, a, b


def chunk_checks(device):
    """``run(chunk=k)`` against k single steps, bit for bit (max |diff| = 0
    over every state, the same ``t`` and step count), on every path: the
    blast (128^3 float32, k = 5, 10 steps; 64^3 float64), the Euler blast
    (128^3 float32, k = 5), the Euler wind bubble (128^3 float32, one step
    alone for the wind's first-step cap, then k = 5), a ``tmax`` that
    lands inside a chunk (blast 64^3 float64), the H II region (128^3
    float32, k = 5), the coupled flagship (2 x 128^3 float32: one step
    alone, then k = 6; and 2 x 32^3 float64, k = 2).  Returns the records
    and the float32 runs (chunked, single steps) by path, whose graphs
    ``chunk_timing`` replays."""
    from pion_tpu_torch import NGHierarchy, Simulation
    from pion_tpu_torch.ics import blast_wave

    recs, runs = {}, {}

    def blast(shape, dtype):
        cfg = main_cfg(shape, dtype)
        P0 = blast_wave(cfg, B0=(0.1, 0.05, 0.0))
        return lambda: Simulation(cfg, P0)

    rec, a, b = chunk_case(blast((128,) * 3, "float32"), "blast float32",
                           BLAST_LAUNCHES, max_steps=10, chunk=5)
    recs["blast_float32"], runs["blast"] = rec, (a, b, 5, BLAST_LAUNCHES)
    # the Euler blast, and the Euler wind bubble (a run with a wind takes its
    # first step alone)
    ecfg = main_cfg((128,) * 3, "float32", eqn="euler", solver="hll")
    eP0 = blast_wave(ecfg)
    rec, a, b = chunk_case(lambda: Simulation(ecfg, eP0), "Euler float32",
                           BLAST_LAUNCHES, max_steps=10, chunk=5)
    recs["euler_float32"], runs["euler"] = rec, (a, b, 5, BLAST_LAUNCHES)
    wcfg, wP0, make_wphys = euler_wind_problem(128, "float32")
    rec, a, b = chunk_case(
        lambda: Simulation(wcfg, wP0, physics=make_wphys()),
        "Euler wind float32", HII_LAUNCHES, first=1, max_steps=11, chunk=5)
    rec["state"] = check_euler_wind(a, "Euler wind, chunked")
    recs["euler_wind_float32"] = rec
    runs["euler_wind"] = (a, b, 5, HII_LAUNCHES)
    recs["blast_float64"] = chunk_case(
        blast((64,) * 3, "float64"), "blast float64", BLAST_LAUNCHES,
        max_steps=10, chunk=5)[0]
    make = blast((64,) * 3, "float64")
    c = make().run(max_steps=7)
    tmax = c.t + 0.5 * c.last_dt
    rec = chunk_case(make, "blast float64, tmax inside a chunk",
                     BLAST_LAUNCHES, tmax=tmax, chunk=5)[0]
    if not (rec["steps"] % 5 and rec["t"] <= tmax):
        raise AssertionError(f"tmax {tmax!r} was not reached inside a "
                             f"chunk: {rec}")
    recs["blast_float64_tmax"] = dict(rec, tmax=tmax)

    cfg, P0, make_physics = hii_problem(128, "float32")
    rec, a, b = chunk_case(
        lambda: Simulation(cfg, P0, physics=make_physics()), "H II float32",
        HII_LAUNCHES, max_steps=10, chunk=5)
    recs["hii_float32"], runs["hii"] = rec, (a, b, 5, HII_LAUNCHES)

    for n, dtype, steps, k in ((128, "float32", 7, 6), (32, "float64", 3, 2)):
        ccfg, states, make_cphys = coupled_problem(n, dtype)

        def make_hier():
            hier = NGHierarchy(ccfg, 2, physics=make_cphys())
            hier.set_states(states)
            return hier

        rec, a, b = chunk_case(make_hier, f"coupled {dtype}", NG_LAUNCHES,
                               first=1, max_steps=steps, chunk=k)
        check_hierarchy(a, f"coupled {dtype}, chunked")
        recs[f"coupled_{dtype}"] = rec
        if dtype == "float32":
            runs["coupled"] = (a, b, k, NG_LAUNCHES)
    return recs, runs


def chunk_timing(runs, rounds: int = 4) -> dict:
    """For each path, in this call: the host clock a step one step at a time
    and ``chunk`` steps at a time (``rounds`` chunks, the graph recorded
    already), the device time a step and the kernels a replay launches (the
    profiler over the same chunks again, from the same state: the step's
    device work moves as the chemistry stiffens), the device's idle share
    (1 - device time over the unprofiled host clock), the capture's seconds
    and the graph pool's bytes.  Each wrapper's
    launches over the timed chunks must be its launches a step times the
    steps (replays counted)."""
    from pion_tpu_torch.microphysics import fused_mpv3 as fm

    out = {}
    for path, (a, b, k, per_step) in runs.items():
        g = chunk_graph(a)

        def timed(run, n, chunk=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.run(max_steps=run.step_count + n, chunk=chunk)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / n * 1.0e3

        n = rounds * k
        step_ms = timed(b, n)
        start = ([x.clone() for x in states_of(a)], a.t, a.step_count,
                 a.last_dt)
        reset_counts()
        chunk_ms = timed(a, n, k)
        counts = read_counts()
        want = {name: v * n for name, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"{path}: launches over {rounds} replays "
                                 f"{counts}, expected {want}")
        P0, a.t, a.step_count, a.last_dt = start
        a.P = P0 if isinstance(a.P, list) else P0[0]
        prof = device_time_by_kernel(
            lambda: a.run(max_steps=a.step_count + n, chunk=k), n)
        rec = {
            "chunk": k, "steps": n, "host_ms_per_step_single": step_ms,
            "host_ms_per_step_chunked": chunk_ms,
            "device_ms_per_step": prof["device_ms_per_step"],
            "device_launches_per_replay":
                prof["device_launches_per_step"] * k,
            "device_ms_per_step_by_group":
                prof["device_ms_per_step_by_group"],
            "wrapper_launches_per_replay": dict(zip(
                ("sweep_axis", "final_axis", "mpv3_ydot", "mpv3_update",
                 "mpv3_update_seeded", "octant_trace"), g.per_replay)),
            "capture_s": g.capture_s, "graph_pool_bytes": g.pool_bytes}
        if prof["device_ms_per_step"] is not None:
            rec["device_idle_share_chunked"] = max(
                0.0, 1.0 - prof["device_ms_per_step"] / chunk_ms)
        out[path] = rec
    fm.update.launches_seeded = 0
    return out


def main_path(shape, dtype, steps: int, agree_tol: float, plain_steps: int,
              **cfg_kw):
    """The library's main path as a user calls it: ``Simulation(cfg,
    P0).run(max_steps=N)`` on the blast wave (configuration 1, or with
    ``cfg_kw`` another system or solver: the Euler path).  Returns the phase
    record, the launch counts of the counted run and the run."""
    from pion_tpu_torch import Simulation
    from pion_tpu_torch.ics import blast_wave
    from pion_tpu_torch.utils import conservation_totals

    cfg = main_cfg(shape, dtype, **cfg_kw)
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
    want = {k: v * steps for k, v in BLAST_LAUNCHES.items()}
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
        "shape": list(shape), "dtype": dtype, "eqn": cfg.eqn.value,
        "solver": cfg.solver.value, "steps": steps, "t": sim.t,
        "launches": counts, "mass_rel_change": mass_err,
        "kernels_vs_plain_2_steps": rel,
        "steps_per_s": steps / sec, "cell_updates_per_s": cells * steps / sec,
        "peak_mem_bytes": peak,
        "plain_steps_per_s": plain_steps / sec_off,
        "plain_cell_updates_per_s": cells * plain_steps / sec_off,
        "plain_peak_mem_bytes": peak_off,
    }
    return rec, counts, sim


def solver_agreement(sim, solvers, agree_tol: float) -> dict:
    """From ``sim``'s evolved state and clock, two steps with each of
    ``solvers`` through the kernels (launches counted: BLAST_LAUNCHES a
    step) and through the plain sweep, compared as ``main_path`` compares
    its own solver.  Returns ``{solver: record}``."""
    from pion_tpu_torch import Simulation

    out = {}
    clock = dict(t=sim.t, step_count=sim.step_count, last_dt=sim.last_dt)
    for solver in solvers:
        cfg = dataclasses.replace(sim.cfg, solver=solver)
        reset_counts()
        a = Simulation(cfg, sim.P, **clock).run(max_steps=sim.step_count + 2)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: 2 * v for k, v in BLAST_LAUNCHES.items()}
        if counts != want:
            raise AssertionError(f"{variant(cfg)}: launch counts {counts}, "
                                 f"expected {want}")
        b = Simulation(dataclasses.replace(cfg, kernels="off"), sim.P,
                       **clock).run(max_steps=sim.step_count + 2)
        if not bool(torch.isfinite(a.P).all()):
            raise AssertionError(f"{variant(cfg)}: non-finite values")
        rel, _ = scaled_err(a.P, b.P)
        if not rel <= agree_tol:
            raise AssertionError(
                f"{variant(cfg)}: kernel and plain paths disagree after 2 "
                f"steps: {rel:.3e} > {agree_tol:.1e}")
        if abs(a.t - b.t) > 1.0e-6 * abs(b.t):
            raise AssertionError(f"{variant(cfg)}: clocks disagree: {a.t} "
                                 f"vs {b.t}")
        out[solver] = {"kernels_vs_plain_2_steps": rel, "launches": counts,
                       "t": a.t}
    return out


# ---------------------------------------------------------------------------
# the photoionised Euler wind bubble
# ---------------------------------------------------------------------------

def euler_wind_problem(n: int, dtype: str, kernels: str = "auto"):
    """The reference's sharded smoke step (``__graft_entry__.py:176-205``) at
    n^3: Euler + HLL (configuration 1's other settings), a 3e18 cm box, MPv3
    monochromatic photoionisation (1e48 s^-1) from a point source at the
    centre, a stellar wind from the same place (radius 2.5 cells, 1e-7
    Msun/yr, 2000 km/s, 3e4 K, tracer 1), nH = 10 at 100 K, x = 1e-6, the
    chemistry dt limit on.  Returns (cfg, P0, make_physics);
    ``make_physics(mp_cls)`` builds the chemistry from ``mp_cls`` (MPv3 by
    default)."""
    from pion_tpu_torch.constants import K_B, MSUN, PG, RO, YEAR
    from pion_tpu_torch.microphysics import MPv3, MPv3Config
    from pion_tpu_torch.physics import Physics
    from pion_tpu_torch.raytracing import Source
    from pion_tpu_torch.winds import WindSource

    L = 3.0e18
    cfg = main_cfg((n,) * 3, dtype, eqn="euler", solver="hll",
                   xmax=(L,) * 3, min_temperature=50.0, tmax=1.0e16,
                   kernels=kernels)
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mono",
                     n_idot=1.0e48, min_temperature=50.0)
    ctr = (0.5 * L,) * 3

    def make_physics(mp_cls=MPv3):
        return Physics(
            mp=mp_cls(mpc),
            sources=[Source(position=ctr, strength=1.0e48, effect="mono")],
            wind_sources=[WindSource(position=ctr, radius=2.5 * cfg.dx,
                                     mdot=1.0e-7 * MSUN / YEAR, vinf=2.0e8,
                                     t_wind=3.0e4, tracers=(1.0,))],
            dt_limit=True)

    nH = 10.0
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 100.0
    P0[cfg.eqn.nbase] = 1.0e-6
    return cfg, P0, make_physics


# kernels against the plain path (``kernels="off"``) after two steps of the
# Euler wind bubble.  The dynamics groups as the H II path's.  Pressure and x
# are what the chemistry writes, and there the two paths run two different
# integrators (ROADMAP C8): the kernel takes its Newton-ladder substeps per
# 1024-cell tile, the plain path over the whole grid.  In the heated,
# partly ionised cells beside the wind they part by 4.9e-4 in pressure and
# 2.1e-5 in x (read on the card).  So pressure is held at 1e-3 and x at
# 1e-4 here, and the sweep and trace kernels alone (the chemistry plain in
# both runs: ``PlainChemistry``) at 1e-5 in every group; B3 and B4 are held
# against their per-tile plain versions call by call in ``mpv3_checks``.
EULER_WIND_TOL = {"mass": 1.0e-5, "velocity": 1.0e-5, "pressure": 1.0e-3,
                  "tracer": 1.0e-4}
EULER_WIND_DYNAMICS_TOL = 1.0e-5


def plain_chemistry_class():
    """MPv3 with its own ``ydot`` re-declared: ``MPv3._use_fused`` then
    keeps it off the chemistry kernels (B3, B4), and a run with
    ``kernels="auto"`` takes the sweep and trace kernels with the plain
    path's chemistry."""
    from pion_tpu_torch.microphysics import MPv3

    class PlainChemistry(MPv3):
        def ydot(self, *args, **kw):
            return MPv3.ydot(self, *args, **kw)

    return PlainChemistry


def check_euler_wind(sim, what: str) -> dict:
    """Finite; x in [0, 1]; T in [50, 1e9] away from the wind (the free
    wind is colder by design); the wind region holds the wind state."""
    P, cfg, phys = sim.P, sim.cfg, sim.physics
    if tuple(P.shape) != (cfg.nvar,) + cfg.shape:
        raise AssertionError(f"{what}: state shape {tuple(P.shape)}")
    if not bool(torch.isfinite(P).all()):
        raise AssertionError(f"{what}: non-finite values in the state")
    x = P[cfg.eqn.nbase]
    xr = (float(x.min()), float(x.max()))
    if not (0.0 <= xr[0] and xr[1] <= 1.0):
        raise AssertionError(f"{what}: ionization fraction outside [0, 1]: "
                             f"{xr}")
    w = phys.winds[0]
    far = w._fields(P)["dist"] > w.src.radius + 2.0 * cfg.dx
    T = phys.mp.temperature(P, cfg)[far]
    Tr = (float(T.min()), float(T.max()))
    if not (50.0 * (1 - 1e-5) <= Tr[0] and Tr[1] <= 1.0e9 * (1 + 1e-5)):
        raise AssertionError(f"{what}: temperature outside [50, 1e9] away "
                             f"from the wind: {Tr}")
    m = w.mask_like(P)
    if not torch.equal(P[:, m], w.wind_state(P, sim.t)[:, m]):
        raise AssertionError(f"{what}: the wind region does not hold the "
                             f"wind state")
    return {"x_range": xr, "T_range_away_from_wind": Tr,
            "wind_cells": int(m.sum())}


def euler_wind_path(device, n: int, steps: int):
    """The photoionised Euler wind bubble as a user runs it:
    ``Simulation(cfg, P0, physics=Physics(mp, sources, wind_sources,
    dt_limit=True)).run(max_steps=N)``.  Returns the phase record and the
    launch counts of the counted run."""
    from pion_tpu_torch import Simulation
    from pion_tpu_torch.constants import PG, RO, VX

    cfg, P0, make_physics = euler_wind_problem(n, "float32")
    cells = n ** 3
    xs = cfg.eqn.nbase
    Simulation(cfg, P0, physics=make_physics()).run(max_steps=2)   # warm-up

    sim = Simulation(cfg, P0, physics=make_physics())
    # the ionised volume in cells, outside the wind region (whose tracer the
    # wind sets to 1)
    outside = ~sim.physics.winds[0].mask_like(sim.P)
    ion0 = float(sim.P[xs][outside].double().sum())
    reset_counts()
    sec, peak = timed_run(sim, steps)
    counts = read_counts()
    if sim.step_count != steps or not sim.t > 0.0:
        raise AssertionError(f"run ended at step {sim.step_count}, t={sim.t}")
    want = {k: v * steps for k, v in HII_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    state = check_euler_wind(sim, "Euler wind")
    ion1 = float(sim.P[xs][outside].double().sum())
    if not ion1 > 1.01 * ion0:
        raise AssertionError(f"the ionised volume did not grow: {ion0} -> "
                             f"{ion1} cells")

    clock = dict(t=sim.t, step_count=sim.step_count, last_dt=sim.last_dt)
    a = Simulation(cfg, sim.P, physics=make_physics(), **clock)
    a.run(max_steps=steps + 2)
    b = Simulation(dataclasses.replace(cfg, kernels="off"), sim.P,
                   physics=make_physics(), **clock)
    sec_off, peak_off = timed_run(b, 2)
    s = Simulation(cfg, sim.P, physics=make_physics(plain_chemistry_class()),
                   **clock)
    s.run(max_steps=steps + 2)
    groups = {"mass": [RO], "velocity": [VX, VX + 1, VX + 2],
              "pressure": [PG], "tracer": [xs]}
    errs = {k: grouped_err(a.P, b.P, [g]) for k, g in groups.items()}
    for k, e in errs.items():
        if not e <= EULER_WIND_TOL[k]:
            raise AssertionError(f"kernel and plain paths disagree after 2 "
                                 f"steps in {k}: {e:.3e} > "
                                 f"{EULER_WIND_TOL[k]:.1e}")
    errs_dyn = {k: grouped_err(s.P, b.P, [g]) for k, g in groups.items()}
    for k, e in errs_dyn.items():
        if not e <= EULER_WIND_DYNAMICS_TOL:
            raise AssertionError(
                f"the sweep and trace kernels and the plain path disagree "
                f"after 2 steps in {k}: {e:.3e} > "
                f"{EULER_WIND_DYNAMICS_TOL:.1e}")
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
        **state, "ionised_volume_cells": [ion0, ion1],
        "kernels_vs_plain_2_steps": errs, "tol": EULER_WIND_TOL,
        "sweep_trace_kernels_vs_plain_2_steps": errs_dyn,
        "tol_sweep_trace": EULER_WIND_DYNAMICS_TOL,
        "clock_rel_diff": clock_diff,
        "steps_per_s": steps / sec, "cell_updates_per_s": cells * steps / sec,
        "peak_mem_bytes": peak, "plain_steps_per_s": 2 / sec_off,
        "plain_cell_updates_per_s": cells * 2 / sec_off,
        "plain_peak_mem_bytes": peak_off, "step_parts": parts,
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
        kw["elapsed_s"] = elapsed_s()
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

    worst, ncase, by_variant = check_kernels(device)
    emit("kernel_checks", cases=ncase,
         max_rel_err={k: {"sweep_axis": v[0], "final_axis": v[1]}
                      for k, v in worst.items()}, tol={"float64": TOL[torch.float64],
                                                       "float32": TOL[torch.float32]},
         max_rel_err_by_variant={
             name: {k: {"sweep_axis": v[0], "final_axis": v[1]}
                    for k, v in by_dtype.items()}
             for name, by_dtype in by_variant.items()},
         tol_mhd_linear_roe={"float64": TOL_MHD_WAVES[torch.float64],
                             "float32": TOL_MHD_WAVES[torch.float32]})
    w_mp, n_mp, ladder = check_mpv3(device)
    emit("mpv3_checks", cases=n_mp, max_soft_rel_err=w_mp, ladder=ladder,
         ydot_grid=check_ydot_grid(device),
         tol={"ydot": {str(k).split(".")[-1]: v for k, v in YDOT_TOL.items()},
              "update": {str(k).split(".")[-1]: v
                         for k, v in UPDATE_TOL.items()},
              "update_stiff_share": STIFF_SHARE,
              "update_stiff_median": STIFF_MEDIAN})
    emit("mpv3_edge_checks", cases=check_mpv3_edges(device),
         tol={str(k).split(".")[-1]: v for k, v in UPDATE_TOL.items()})
    w_tr, n_tr, trace_plans = check_trace(device, big=not args.quick)
    emit("trace_checks", cases=n_tr, max_rel_err=w_tr, plans=trace_plans,
         tol={str(k).split(".")[-1]: v for k, v in TRACE_TOL.items()})
    if args.quick:
        return 0

    rows = measure_kernels(device, worst)
    variants = measure_variants(device)
    phys_rows, hii_sweep = measure_physics_kernels(device)
    rows += phys_rows
    # B1's top-level numbers are the blast path's mix (axes 1 and 2, no
    # tracer clamp); its numbers on the H II path's mix stand under "hii"
    rows[0]["hii"] = hii_sweep
    emit("kernels", kernels=rows, variants=variants)

    rec32, counts, sim32 = main_path((128, 128, 128), "float32", steps=10,
                                     agree_tol=1.0e-4, plain_steps=3)
    # the MHD linear and Roe variants: two steps from the blast's state
    rec32["solvers"] = solver_agreement(sim32, MHD_WAVE_SOLVERS, 1.0e-4)
    del sim32
    emit("main_path", **rec32)
    parts = step_parts(device, steps=5)
    if parts["device_ms_per_step"] is not None:
        # idle share of the device in the unprofiled run above
        parts["device_idle_share"] = max(
            0.0, 1.0 - parts["device_ms_per_step"] * rec32["steps_per_s"] / 1.0e3)
    emit("step_parts", **parts)
    rec64, _, _ = main_path((64, 64, 64), "float64", steps=3,
                            agree_tol=1.0e-9, plain_steps=2)
    emit("main_path_f64", **rec64)
    # the Euler system: a blast with HLL, then the other solvers of the
    # kernels from its state; the same at float64
    rec_e, counts_e, sim_e = main_path((128, 128, 128), "float32", steps=10,
                                       agree_tol=1.0e-4, plain_steps=2,
                                       eqn="euler", solver="hll")
    rec_e["solvers"] = solver_agreement(sim_e, EULER_SOLVERS[1:], 1.0e-4)
    del sim_e
    emit("euler_path", **rec_e)
    rec_e64, _, sim_e64 = main_path((64, 64, 64), "float64", steps=3,
                                    agree_tol=1.0e-9, plain_steps=2,
                                    eqn="euler", solver="hll")
    rec_e64["solvers"] = solver_agreement(sim_e64, EULER_SOLVERS[1:], 1.0e-9)
    del sim_e64
    emit("euler_path_f64", **rec_e64)
    rec_w, counts_w = euler_wind_path(device, 128, steps=10)
    emit("euler_wind_path", **rec_w)
    # float32: the kernels against the plain path over two steps.  In this
    # early phase (dt ~10 s, at most a tile or two of 2048 past the Euler
    # cutoff, two substeps either way) the two ladders take the same steps, so
    # the paths differ by rounding only (read: 8e-8)
    rec_hii, counts_hii = hii_path(device, 128, steps=10, agree_tol=1.0e-5)
    emit("hii_path", **rec_hii)
    # the coupled flagship on two levels; then the same hierarchy without
    # physics, and the double instantiations on the nested-grid traffic
    rec_ng, counts_ng, hier = ng_path(device, 128, steps=6, agree_tol=1.0e-5)
    # every kernel of the path against its plain version on the path's own
    # state, before that state moves on
    ng_rows = {"sweep_axis": measure_ng_sweep(device, hier),
               **measure_ng_physics(device, hier)}
    for row in rows:
        if row["name"] in ng_rows:
            row["ng"] = ng_rows[row["name"]]
    rec_dyn = ng_dynamics(device, 128, 6, hier)
    # profiled last: every timing above was taken before this phase's profiler
    rec_ng["step_parts"] = ng_step_parts(hier, rec_ng["ms_per_step"])
    emit("ng_path", **rec_ng)
    emit("ng_dynamics", **rec_dyn)
    del hier
    rec_ng64, _, hier64 = ng_path(device, 32, steps=2, agree_tol=1.0e-9,
                                  dtype="float64")
    rec_ng64["kernels_on_this_state"] = measure_ng_physics(
        device, hier64, timed=False)
    emit("ng_path_f64", **rec_ng64)
    del hier64

    # several steps in one dispatch: each path's chunked run against its
    # single steps, then both timed in this call
    rec_chunk, chunk_runs = chunk_checks(device)
    emit("chunk_checks", cases=rec_chunk)
    emit("chunk_timing", **chunk_timing(chunk_runs))
    del chunk_runs

    # launches on the main paths: each kernel's count from the run of the
    # path its numbers were measured for (B1 and B2: the blast wave, and B1
    # again under "hii" and "ng"; the rest: the H II run); every path's
    # count stands under "launches_by_path"
    for row in rows:
        name = row["name"]
        blast = name in ("sweep_axis", "final_axis")
        row["launches"] = counts[name] if blast else counts_hii[name]
        row["launches_by_path"] = {"blast": counts[name],
                                   "hii": counts_hii[name],
                                   "ng": counts_ng[name]}
        if row["launches"] < 1:
            raise AssertionError(f"{name} was not launched on its main path")
    hii_sweep["launches"] = counts_hii["sweep_axis"]
    if hii_sweep["launches"] < 1:
        raise AssertionError("sweep_axis was not launched on the H II path")
    for name, per_step in NG_LAUNCHES.items():
        if per_step and counts_ng[name] < 1:
            raise AssertionError(f"{name} was not launched on the "
                                 f"nested-grid path")
        if per_step:
            ng_rows[name]["launches"] = counts_ng[name]
    # B1 and B2 by variant: launches from the run of each (the Euler path's
    # HLL run, and the two steps of each other solver), the kernels'
    # numbers from the ``kernels`` phase, the errors from ``kernel_checks``
    runs_by_variant = {"euler_hll": counts_e}
    runs_by_variant.update({f"euler_{s}": r["launches"]
                            for s, r in rec_e["solvers"].items()})
    runs_by_variant.update({f"mhd_{s}": r["launches"]
                            for s, r in rec32["solvers"].items()})
    for row in rows[:2]:
        name = row["name"]
        row["variants"] = []
        for v, launched in runs_by_variant.items():
            if launched[name] < 1:
                raise AssertionError(f"{name} {v} was not launched on its "
                                     f"path")
            entry = {"name": v, "launches": launched[name],
                     "max_rel_err_f64": by_variant[v]["float64"][
                         0 if name == "sweep_axis" else 1],
                     "max_rel_err_f32": by_variant[v]["float32"][
                         0 if name == "sweep_axis" else 1]}
            entry.update(variants.get(v, {}).get(name, {}))
            if v == "mhd_roe_pv":
                entry["kernel_of"] = "mhd_linear"
            row["variants"].append(entry)
    for row in rows:
        row["launches_by_path"].update(euler=counts_e[row["name"]],
                                       euler_wind=counts_w[row["name"]])
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
