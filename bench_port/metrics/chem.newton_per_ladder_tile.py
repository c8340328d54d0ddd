"""Newton iterations a ladder tile of B3: the program's counters
``chem.newton_iters`` over ``chem.ladder_tiles`` in pass (a) of
``bench_port/spans.py``."""
from bench_port import spans


def read(ctx):
    r = spans.result(ctx)
    return None if r is None else r["host"]["newton_per_ladder_tile"]
