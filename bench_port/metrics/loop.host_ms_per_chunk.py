"""The host's own ms a chunk in the run loop: the span ``run.chunk`` less
``run.readback`` and less the graph's launch (``cudaGraphLaunch``), both of
which wait for the device, so what is left is the sources, the graph's
input copies and output clones and the clock's bookkeeping; from the
profiler's ranges of each chunk in pass (a) of ``bench_port/spans.py``
(graph replays, tracing "host")."""
from bench_port import spans


def read(ctx):
    r = spans.result(ctx)
    return None if r is None else r["host"]["loop_ms_per_chunk"]
