"""Initial conditions (the icgen equivalent): the blast wave, the one a
cell of the benchmark builds here (reference: source/ics/icgen.cpp)."""
from .blast import blast_wave  # noqa: F401
