"""Cell-updates the window completed over its seconds, in millions a second
(level l of a hierarchy counted 2^l times a step)."""


def read(ctx):
    win = ctx["window"]
    return win["completed"] * ctx["cells_per_step"] / win["seconds"] / 1.0e6
