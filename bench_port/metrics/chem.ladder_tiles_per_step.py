"""Tiles that ran B3's Newton ladder a step: the program's counter
``chem.ladder_tiles`` over the traced chunks' steps in pass (a) of
``bench_port/spans.py`` (graph replays, the counters on)."""
from bench_port import spans


def read(ctx):
    r = spans.result(ctx)
    return None if r is None else r["host"]["ladder_tiles_per_step"]
