"""Interface planes a step that B1 hands to the nested-grid glue: the
program's counter ``fused_sweep.sweep_axis.planes`` in pass (a) of
``bench_port/spans.py`` (graph replays, the counters on) over the traced
chunks' steps (pass (a) runs the traced pass's chunks, so their steps).
A program without that counter leaves the metric out."""
from bench_port import spans


def read(ctx):
    r = spans.result(ctx)
    if r is None:
        return None
    planes = r["host"]["counters"].get("fused_sweep.sweep_axis.planes")
    steps = ctx["profile"]["steps"]
    return None if planes is None or not steps else planes / steps
