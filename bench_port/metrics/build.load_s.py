"""Seconds of the kernels' build and load (``_build.load_all``): a load
from ``pion_tpu_torch/build/`` once built there."""


def read(ctx):
    return ctx["build_load_s"]
