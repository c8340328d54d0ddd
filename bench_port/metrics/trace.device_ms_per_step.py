"""Device ms a step of the octant trace B5 (``octant_trace_*``)."""
from bench_port.profiling import group_s


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["steps"]:
        return None
    s = group_s(prof, "trace")
    return s / prof["steps"] * 1.0e3 if s > 0 else None
