"""Raytracing: point-source short characteristics and parallel rays."""
from .tracer import (PointSourceTracer, Raytracer, Source,  # noqa: F401
                     StarEvolution, parallel_rays)
