"""Device memory the chunk graph's private pool reserves
(``ChunkGraph.pool_bytes``), in GiB."""


def read(ctx):
    g = ctx["graph"]
    return None if g is None else g["pool_bytes"] / 2.0 ** 30
