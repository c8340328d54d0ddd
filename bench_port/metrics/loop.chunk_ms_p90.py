"""The 90th percentile of the window's chunks, each the host clock around
one ``run(chunk=k)`` call (which ends in a synchronise), in ms."""
from bench_port.harness import quantile


def read(ctx):
    chunks = ctx["window"]["chunk_s"]
    return quantile(chunks, 0.9) * 1.0e3 if chunks else None
