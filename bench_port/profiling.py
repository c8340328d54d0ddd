"""Device time of a few chunks from ``torch.profiler``: each kernel's time,
the device's busy seconds, and the idle gaps named by what the host did.

The grouping follows the port's kernel names: the fused sweep (B1, B2), the
chemistry (B3, B4), the octant trace (B5); every other device operation
(PyTorch's elementwise, reduction, index and copy kernels) is a plain pass.
"""
from __future__ import annotations

import time

GROUPS = {
    "sweep": ("sweep_axis_kernel", "final_axis_kernel"),
    "chem": ("update_euler_kernel", "update_ladder_kernel", "ydot_kernel"),
    "trace": ("octant_trace_cluster_kernel", "octant_trace_global_kernel"),
}
TOP = 10
NAMED_GAPS = 200


def group_of(name: str) -> str:
    return next((g for g, keys in GROUPS.items()
                 if any(k in name for k in keys)), "plain")


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(step_chunk, chunks: int, label: str = "bench.chunk") -> dict:
    """Profile ``chunks`` calls of ``step_chunk()`` (each ends in a
    synchronise, and returns the steps it took).  Returns ``steps``,
    ``window_s`` (host clock over the calls), ``busy_s`` (the union of the
    device operations' intervals), ``kernel_s`` (seconds by kernel name),
    ``device_ops`` and ``idle_gaps`` (the ten largest, as name and
    seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    steps = 0
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            with record_function(label):
                steps += step_chunk()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    cpu, dev = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the harness's own range shows on the device's timeline too
            if e.name != label:
                dev.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    kernel_s = {}
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1.0e6
    busy = _merged([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1.0e6
    # idle gaps between device work: the longest each named by the
    # innermost host operation running at its middle, the rest (inside a
    # replay, a few microseconds each) summed under one name
    between = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _)
                      in zip(busy, busy[1:])), reverse=True)
    gaps = {}
    for i, (us, e0, s1) in enumerate(between):
        if i < NAMED_GAPS:
            mid = 0.5 * (e0 + s1)
            over = [(e - s, name) for s, e, name in cpu if s <= mid <= e]
            name = min(over)[1] if over else "host: nothing traced"
        else:
            name = f"shorter gaps ({len(between) - NAMED_GAPS})"
        gaps[name] = gaps.get(name, 0.0) + us / 1.0e6
    short = {}
    for name, sec in kernel_s.items():
        short[name[:60]] = short.get(name[:60], 0.0) + sec
    return {
        "steps": steps, "window_s": window_s, "busy_s": busy_s,
        "kernel_s": kernel_s,
        "device_ops": sorted(([k, v] for k, v in short.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def group_s(prof: dict, group: str) -> float:
    """Seconds of one group's device operations in the profiled chunks."""
    return sum(s for name, s in prof["kernel_s"].items()
               if group_of(name) == group)
