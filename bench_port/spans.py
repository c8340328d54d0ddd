"""Device time by span, the host's turn between chunks and the chemistry
ladder's counters, from the program's own spans and counters
(``pion_tpu_torch.tracing``), for the per-layer metrics that read them.

A ``--trace 1`` run hands its readers ``ctx`` once the window, the traced
chunks and the comparison are done and the program's run is freed.  The
first reader that asks (:func:`result`) sets the cell up once more from the
run's own inputs (the harness's ``run_cell`` holds them: its seed's states,
its device and kernels) with tracing on, and runs the traffic's traced
chunks (``trace_from``, ``trace_chunks``) twice more under
``torch.profiler``, each from the restored episode:

- pass (a), ``tracing.enable("host")``: the chunks replay their CUDA graph
  (recorded at set-up with the counters on), as in the window.  It gives
  the run loop's spans (host seconds a chunk, from the program's registry;
  each chunk's split and the host's own share of it, from the profiler),
  the counters, and each idle gap
  of the device named by the innermost program span on the host at its
  middle;
- pass (b), ``tracing.enable("device")``: the same chunks run their body
  eagerly (the chunks before them still replay), so each device operation
  lies under the innermost span that launched it (the profiler's GPU user
  annotations); its device time is summed by that span.

The readings are kept in ``ctx["spans"]`` and printed once, as one line
``spans {...}`` on standard error (not a metric): device ms a step and host
ms a chunk of each span, the named gaps, ``unattributed_ms_per_step`` (device
time under no span of the step's body), the counters, what stands the eager
pass for the graph (its busy and plain ms a step beside the traced pass's,
the graph's input copies and output clones), and the passes' cost.  Where
the program has no ``tracing`` module (a program older than its spans),
every reading is None and the metrics are left out; where it has one, a
pass that fails, or inputs of the run that cannot be found, fail the run.
"""
from __future__ import annotations

import json
import sys
import time

from bench_port import harness
from bench_port.profiling import group_of

TOP = 10
NO_SPAN = "outside the program's spans"
# the CUDA runtime's launch of a graph: on a graph of ~10^5 nodes it waits
# for the device to drain the command buffer, so its time is the device's
GRAPH_LAUNCH = "cudaGraphLaunch"


def result(ctx):
    """The passes' readings for this run (made at the first call), or
    None."""
    if "spans" not in ctx:
        ctx["spans"] = _measure(ctx)
        if ctx["spans"] is not None:
            print("spans " + json.dumps(ctx["spans"]), file=sys.stderr)
    return ctx["spans"]


def device_ms(ctx, names, plain_only=False):
    """Device ms a step of pass (b) under the spans ``names`` (the plain
    operations alone with ``plain_only``: outside B1-B5), or None where
    none of them ran (or nothing ran on a device)."""
    r = result(ctx)
    if r is None or r["eager"] is None:
        return None
    by = r["eager"]["plain_ms_per_step" if plain_only
                    else "device_ms_per_step"]
    if not any(n in r["eager"]["calls"] for n in names):
        return None
    return sum(by.get(n, 0.0) for n in names)


def _run_inputs():
    """What ``harness.run_cell`` ran the cell on: its inputs, device,
    kernels, configuration, traffic and program (raising where no frame of
    ``run_cell`` holds them)."""
    f = sys._getframe()
    while f is not None:
        if (f.f_code.co_name == "run_cell"
                and f.f_globals.get("__name__") == "bench_port.harness"):
            loc = f.f_locals
            keys = ("states", "dev", "kernels", "config", "traffic",
                    "program")
            missing = [k for k in keys if k not in loc]
            if missing:
                raise RuntimeError(f"bench_port.spans: harness.run_cell "
                                   f"holds no {', '.join(missing)}")
            return {k: loc[k] for k in keys}
        f = f.f_back
    raise RuntimeError("bench_port.spans: its readers run inside "
                       "harness.run_cell, whose inputs the passes reuse")


def _measure(ctx):
    try:
        from pion_tpu_torch import tracing
    except ImportError:         # a program without spans: metrics left out
        return None
    if not ctx.get("profile"):
        raise RuntimeError("bench_port.spans: the passes follow a traced "
                           "run (--trace 1)")
    run = _run_inputs()
    try:
        return _passes(ctx, tracing, **run)
    finally:
        tracing.disable()
        harness.free(run["dev"])


def _passes(ctx, tracing, states, dev, kernels, config, traffic, program):
    """Set the cell up again with tracing on, run passes (a) and (b) over
    the traced chunks, and read them beside the traced pass of ``ctx``."""
    t0 = time.perf_counter()
    harness.free(dev)
    tracing.enable("host")
    ep = harness.set_up(program, config, traffic, states, kernels, dev)
    set_up_s = time.perf_counter() - t0
    g = ep.graph()
    a = harness.traced(ep, traffic,
                       lambda f, n: recorded(f, n, tracing, dev, None))
    t1 = time.perf_counter()
    b = harness.traced(ep, traffic,
                       lambda f, n: recorded(f, n, tracing, dev, "device"))
    pass_b_s = time.perf_counter() - t1
    tracing.disable()
    del ep
    prof = ctx["profile"]
    out = {
        "host": host_pass(a, tracing.is_span),
        "eager": eager_pass(b, tracing.is_span, tracing.RUN_SPANS),
        "cost": {
            "set_up_s": set_up_s,
            "capture_s": None if g is None else g.capture_s,
            "pass_a_chunk_ms": a["window_s"] / a["chunks"] * 1.0e3,
            "traced_pass_chunk_ms": (prof["window_s"]
                                     / int(traffic["trace_chunks"]) * 1.0e3),
            "pass_b_s": pass_b_s,
            "profiler_stop_s": [a["stop_s"], b["stop_s"]],
            "profiler_read_s": [a["read_s"], b["read_s"]],
            "pass_b_chunk_host_s": b["registry"]["spans"].get(
                "run.chunk", {}).get("host_s"),
            "added_s": time.perf_counter() - t0,
        },
    }
    steps = prof["steps"]
    out["checks"] = {
        "traced_busy_ms_per_step": prof["busy_s"] / steps * 1.0e3,
        "traced_plain_ms_per_step": sum(
            s for name, s in prof["kernel_s"].items()
            if group_of(name) == "plain") / steps * 1.0e3,
        "replay_copies_ms_per_step": a["copies_us"] / a["steps"] / 1.0e3,
    }
    if out["eager"] is not None:
        e, c = out["eager"], out["checks"]
        c["eager_busy_ms_per_step"] = e["busy_ms_per_step"]
        c["eager_plain_ms_per_step"] = sum(e["plain_ms_per_step"].values())
        c["eager_over_traced_busy"] = (e["busy_ms_per_step"]
                                       / c["traced_busy_ms_per_step"])
    return out


def recorded(step_chunk, chunks: int, tracing, dev, mode) -> dict:
    """``chunks`` calls of ``step_chunk()`` under ``torch.profiler`` (with
    tracing switched to ``mode`` first, where one is given): the steps,
    host seconds, the profiler's host ranges and device operations as
    ``(start_us, end_us, name)``, the device microseconds that
    ``aten::copy_`` launched inside ``run.replay`` (a graph's input copies
    and output clones), the registry's change over the calls, and the
    seconds the profiler took to stop and to be read.  The profiler's raw
    events are read (``kineto_results``), not its event tree: an eager
    chunk of the front holds some 10^5 operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if mode is not None:
        tracing.enable(mode)
    before = tracing.summary()
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    steps = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            steps += step_chunk()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    stop_s = t1 - t0 - window_s
    registry = changed(before, tracing.summary())
    cuda = torch.autograd.DeviceType.CUDA
    cpu, ops, copies, launched = [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1.0e3
        item = (start, start + e.duration_ns() / 1.0e3, e.name())
        if e.device_type() == cuda:
            ops.append(item)
            c = e.linked_correlation_id()
            if c > 0:
                launched[c] = launched.get(c, 0.0) + (item[1] - item[0])
        else:
            cpu.append(item)
            if item[2] == "aten::copy_":
                copies.append((item[0], item[1], e.correlation_id()))
    span_ranges = [r for r in cpu if tracing.is_span(r[2])]
    inside = innermost([0.5 * (s + e) for s, e, _ in copies], span_ranges)
    return {"steps": steps, "chunks": chunks, "window_s": window_s,
            "cpu": cpu, "ops": ops, "registry": registry,
            "copies_us": sum(launched.get(c, 0.0) for (_, _, c), name
                             in zip(copies, inside) if name == "run.replay"),
            "stop_s": stop_s, "read_s": time.perf_counter() - t1}


def changed(before: dict, after: dict) -> dict:
    """The registry's change between two summaries: spans (calls, host
    seconds) and counters (ints, or ints by graph)."""
    spans = {}
    for name, s in after["spans"].items():
        b = before["spans"].get(name, {"calls": 0, "host_s": 0.0})
        if s["calls"] != b["calls"]:
            spans[name] = {"calls": s["calls"] - b["calls"],
                           "host_s": s["host_s"] - b["host_s"]}
    counters = {}
    for name, v in after["counters"].items():
        w = before["counters"].get(name, {} if isinstance(v, dict) else 0)
        if isinstance(v, dict):
            counters[name] = {k: n - w.get(k, 0) for k, n in v.items()
                              if n != w.get(k, 0)}
        else:
            counters[name] = v - w
    return {"spans": spans, "counters": counters}


def innermost(points, ranges) -> list:
    """For each time in ``points``, the name of the innermost of
    ``ranges`` (``(start, end, name)``, nested or apart, as the ranges of
    one thread or of one stream are) open at it, or None."""
    # at one instant: the longer range opens first and closes last
    events = [(s, 0, s - e, i) for i, (s, e, _) in enumerate(ranges)]
    events += [(e, 2, e - s, i) for i, (s, e, _) in enumerate(ranges)]
    events += [(t, 1, 0, j) for j, t in enumerate(points)]
    events.sort()
    out = [None] * len(points)
    stack = []
    for _, kind, _, i in events:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            if stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
        elif stack:
            out[i] = ranges[stack[-1]][2]
    return out


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_pass(rec: dict, is_span) -> dict:
    """Pass (a): host ms a chunk of each span (the registry), each chunk's
    split (the profiler's ranges inside each ``run.chunk``, the graph's
    launch among them), the host's own ms a chunk, the CUDA runtime's
    and driver's calls (``cu...``) inside the chunks outside
    ``run.readback``, the counters'
    change, ladder tiles a step and Newton iterations a tile, the device's
    busy ms a step, and its idle gaps named by the innermost program span
    at their middle.

    The host's own ms of a chunk is ``run.chunk`` less ``run.readback``
    (a wait for the device) less the graph's launch (``cudaGraphLaunch``,
    which waits for the device where the graph outgrows the command
    buffer): the sources, the input copies, the output clones and the
    clock's bookkeeping."""
    chunks, steps = rec["chunks"], rec["steps"]
    reg = rec["registry"]
    host = {name: s["host_s"] / chunks * 1.0e3
            for name, s in reg["spans"].items()}
    spans = [r for r in rec["cpu"] if is_span(r[2])]
    calls = [r for r in rec["cpu"] if r[2].startswith("cu")]
    split, runtime = [], {}
    for s, e, name in sorted(spans):
        if name != "run.chunk":
            continue
        part = {"run.chunk": (e - s) / 1.0e3}
        for s2, e2, n2 in spans:
            if s <= s2 and e2 <= e and n2 != "run.chunk":
                part[n2] = part.get(n2, 0.0) + (e2 - s2) / 1.0e3
        waits = [(s2, e2) for s2, e2, n2 in spans
                 if n2 == "run.readback" and s <= s2 and e2 <= e]
        for s2, e2, n2 in calls:
            if s <= s2 and e2 <= e and not any(
                    a <= s2 and e2 <= b for a, b in waits):
                ms = (e2 - s2) / 1.0e3
                runtime[n2] = runtime.get(n2, 0.0) + ms / chunks
                if n2.startswith(GRAPH_LAUNCH):
                    part[GRAPH_LAUNCH] = part.get(GRAPH_LAUNCH, 0.0) + ms
        split.append(part)
    own = [p["run.chunk"] - p.get("run.readback", 0.0)
           - p.get(GRAPH_LAUNCH, 0.0) for p in split]
    # the spans' annotations on the device timeline are not device work
    busy = merged([(s, e) for s, e, name in rec["ops"] if not is_span(name)])
    gaps = [(s1 - e0, 0.5 * (e0 + s1)) for (_, e0), (s1, _)
            in zip(busy, busy[1:])]
    names = innermost([mid for _, mid in gaps], spans)
    named = {}
    for (us, _), name in zip(gaps, names):
        name = name or NO_SPAN
        named[name] = named.get(name, 0.0) + us / 1.0e6
    c = reg["counters"]
    tiles, newton = c.get("chem.ladder_tiles"), c.get("chem.newton_iters")
    return {
        "host_ms_per_chunk": host,
        "loop_ms_per_chunk": sum(own) / len(own) if own else None,
        "chunks": split,
        "runtime_ms_per_chunk": dict(sorted(
            runtime.items(), key=lambda kv: -kv[1])[:TOP]),
        "counters": c,
        "ladder_tiles_per_step": (None if tiles is None or not steps
                                  else tiles / steps),
        "newton_per_ladder_tile": newton / tiles if tiles else None,
        "busy_ms_per_step": (sum(e - s for s, e in busy) / 1.0e3 / steps
                             if steps else None),
        "idle_gaps": sorted(([k, v] for k, v in named.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def eager_pass(rec: dict, is_span, run_spans) -> dict:
    """Pass (b): each device operation's time summed under the innermost
    span over it on the device timeline, in ms a step, all of it and the
    plain operations alone (outside B1-B5), and each span's three largest
    operations by name; ``unattributed_ms_per_step``:
    device time under no span of the step's body (none, or a run-loop
    span); the spans' calls; or None where nothing ran on a device."""
    notes = [r for r in rec["ops"] if is_span(r[2])]
    ops = [r for r in rec["ops"] if not is_span(r[2])]
    if not ops:
        return None
    steps = rec["steps"]
    under = innermost([0.5 * (s + e) for s, e, _ in ops], notes)
    total, plain, by_op = {}, {}, {}
    unattributed = 0.0
    for (s, e, name), span in zip(ops, under):
        ms = (e - s) / 1.0e3 / steps
        if span is None or span in run_spans:
            unattributed += ms
        key = span or NO_SPAN
        total[key] = total.get(key, 0.0) + ms
        if group_of(name) == "plain":
            plain[key] = plain.get(key, 0.0) + ms
        op = by_op.setdefault(key, {})
        op[name[:60]] = op.get(name[:60], 0.0) + ms
    busy = sum(e - s for s, e in merged([(s, e) for s, e, _ in ops]))
    return {"device_ms_per_step": total, "plain_ms_per_step": plain,
            "top_ops": {k: sorted(([n, ms] for n, ms in v.items()),
                                  key=lambda kv: -kv[1])[:3]
                        for k, v in by_op.items()},
            "unattributed_ms_per_step": unattributed,
            "busy_ms_per_step": busy / 1.0e3 / steps,
            "calls": {n: s["calls"]
                      for n, s in rec["registry"]["spans"].items()}}
