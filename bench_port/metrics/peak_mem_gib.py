"""Peak device memory over set-up and window (``max_memory_allocated``,
graph pools included), in GiB."""


def read(ctx):
    return ctx["memory_peak_bytes"] / 2.0 ** 30
