"""Snapshot format converters (the silo2ascii / silo2fits equivalents).

Counterpart of the JAX package's ``pion_tpu/analysis/export.py``, writing
the same files; the state may be a torch tensor on any device or a numpy
array.

Reference: analysis/silo2ascii, analysis/silo2fits.  Exports:
- ASCII column tables (position + all primitive variables)
- legacy-VTK structured points, directly loadable in VisIt/ParaView (the
  role Silo multimeshes play for the reference's VisIt workflow)
FITS export lives in io/fits.py (pure-Python writer/reader incl.
``npz_to_fits``); the .npz snapshot is the native interchange format.
"""
from __future__ import annotations

import numpy as np

from ..config import SimConfig
from ..io.compare import VAR_NAMES
from ..io.snapshot import _host_array


def _var_names(cfg: SimConfig):
    names = VAR_NAMES[: cfg.eqn.nbase]
    names = names + [f"tr{i}" for i in range(cfg.ntracer)]
    return names


def to_ascii(path: str, P, cfg: SimConfig, t: float = 0.0) -> str:
    """Write one row per cell: coordinates then primitive variables."""
    P = _host_array(P)
    coords = [cfg.cell_centers(ax) for ax in range(cfg.ndim)]
    grids = np.meshgrid(*coords, indexing="ij")
    names = _var_names(cfg)
    cols = [g.ravel() for g in grids] + [P[v].ravel() for v in range(cfg.nvar)]
    header = (f"pion_tpu snapshot t={t:.8e}\n"
              + " ".join([f"x{ax}" for ax in range(cfg.ndim)] + names))
    np.savetxt(path, np.column_stack(cols), header=header)
    return path


def to_vtk(path: str, P, cfg: SimConfig, t: float = 0.0) -> str:
    """Write a legacy-VTK STRUCTURED_POINTS file with all variables."""
    P = _host_array(P)
    if not path.endswith(".vtk"):
        path += ".vtk"
    nd = cfg.ndim
    dims = [1, 1, 1]
    for ax in range(nd):
        dims[ax] = cfg.shape[nd - 1 - ax]  # VTK wants (nx, ny, nz)
    origin = [0.0, 0.0, 0.0]
    for ax in range(nd):
        origin[ax] = cfg.xmin[nd - 1 - ax] + 0.5 * cfg.dx
    names = _var_names(cfg)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"pion_tpu snapshot t={t:.8e}\n")
        f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write(f"ORIGIN {origin[0]:.8e} {origin[1]:.8e} {origin[2]:.8e}\n")
        f.write(f"SPACING {cfg.dx:.8e} {cfg.dx:.8e} {cfg.dx:.8e}\n")
        npoints = int(np.prod(cfg.shape))
        f.write(f"POINT_DATA {npoints}\n")
        for v, name in enumerate(names):
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            # VTK x-fastest ordering == our array C-order reversed
            np.savetxt(f, P[v].ravel(order="C")[None].T, fmt="%.8e")
    return path
