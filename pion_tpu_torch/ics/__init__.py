"""Initial-condition generators (the icgen equivalent).

Each generator returns a primitive-state numpy array for a given
:class:`~pion_tpu_torch.config.SimConfig` (reference:
source/ics/icgen.cpp:83-257 dispatch at icgen_base.cpp:36-130).  Only the
generators that have been ported are exported.
"""
from .blast import blast_wave  # noqa: F401
