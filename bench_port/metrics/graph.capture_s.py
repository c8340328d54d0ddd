"""Seconds of the chunk graph's capture (``ChunkGraph.capture_s``)."""


def read(ctx):
    g = ctx["graph"]
    return None if g is None else g["capture_s"]
