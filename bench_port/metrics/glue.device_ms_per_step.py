"""Device ms a step of the nested-grid glue: the spans ``glue.prolong``
(the fine levels' prolonged ghosts), ``glue.restrict`` (restriction and
the boundary planes' restriction) and ``glue.bc89`` (the BC89 correction
and the interface planes recomputed for it), from pass (b) of
``bench_port/spans.py``."""
from bench_port import spans


def read(ctx):
    return spans.device_ms(ctx, ("glue.prolong", "glue.restrict",
                                 "glue.bc89"))
