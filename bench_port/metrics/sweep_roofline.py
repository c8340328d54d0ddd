"""The fused sweep's (B1 and B2) share of its roofline, in %: the least
time of a step's sweep launches (``roofline.sweep_launches``) over their
device time a step in the profiled chunks."""
from bench_port import roofline
from bench_port.profiling import group_s


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["steps"]:
        return None
    s = group_s(prof, "sweep") / prof["steps"]
    if s <= 0:
        return None
    least = roofline.least_s(roofline.sweep_launches(ctx["config"]),
                             ctx["config"]["sim"]["dtype"])
    return least / s * 100.0
