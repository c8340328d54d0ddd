"""Device ms a step of the chemistry kernels B3 and B4
(``update_euler_kernel``, ``update_ladder_kernel``, ``ydot_kernel``)."""
from bench_port.profiling import group_s


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["steps"]:
        return None
    s = group_s(prof, "chem")
    return s / prof["steps"] * 1.0e3 if s > 0 else None
