"""Device ms a step of the plain operations (outside the kernels B1-B5)
under the spans ``chem`` and ``trace``: the chemistry's and the trace's
own PyTorch passes around B3, B4 and B5, from pass (b) of
``bench_port/spans.py``."""
from bench_port import spans


def read(ctx):
    return spans.device_ms(ctx, ("chem", "trace"), plain_only=True)
