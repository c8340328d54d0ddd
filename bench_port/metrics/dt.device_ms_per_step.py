"""Device ms a step under the span ``step.dt`` (the CFL reduction, the
chemistry's dt limit with its B4 ``ydot``, the growth limit and cap; the
trace inside it is the trace's), from pass (b) of
``bench_port/spans.py``."""
from bench_port import spans


def read(ctx):
    return spans.device_ms(ctx, ("step.dt",))
