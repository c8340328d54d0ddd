"""Device ms a step under the span ``fill`` (the boundary fill of a
level-0 or single grid, ``apply_bcs``, and a fine level's domain faces),
from pass (b) of ``bench_port/spans.py`` (eager, tracing "device")."""
from bench_port import spans


def read(ctx):
    return spans.device_ms(ctx, ("fill",))
