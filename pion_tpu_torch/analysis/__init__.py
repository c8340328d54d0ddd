"""Analysis tools of the port: synthetic projections and format exports
(the names of the JAX package's ``pion_tpu/analysis``)."""
from .projection import (  # noqa: F401
    emission_measure,
    halpha_emissivity,
    nii6584_emissivity,
    project_3d,
    project_3d_los,
    project_axisymmetric,
    xray_emissivity,
)
from .export import to_ascii, to_vtk  # noqa: F401
