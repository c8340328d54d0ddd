"""Device ms a step of every operation outside the port's kernels B1-B5:
PyTorch's elementwise, reduction, index and copy kernels (the plain passes
and the hierarchy's glue), from the profiled chunks."""
from bench_port.profiling import group_s


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["steps"] or not prof["kernel_s"]:
        return None
    return group_s(prof, "plain") / prof["steps"] * 1.0e3
