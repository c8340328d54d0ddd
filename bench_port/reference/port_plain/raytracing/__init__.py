"""Raytracing: point-source short characteristics and parallel rays."""
from .tracer import Raytracer, Source, StarEvolution, parallel_rays  # noqa: F401
