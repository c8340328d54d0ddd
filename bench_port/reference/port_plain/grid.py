"""Grid geometry: dense precomputed coordinate/metric arrays.

The reference attaches geometry to a linked list of cell structs and a
``VectorOps_{Cart,Cyl,Sph}`` class hierarchy (reference: source/coord_sys/
VectorOps.cpp, VectorOps_spherical.cpp, source/grid/uniform_grid.cpp).  Here
geometry is a handful of small 1D numpy arrays computed once per run;
``Geometry.axis_tensors`` hands them to the sweeps as tensors of the state's
dtype on the state's device, cast once and cached per geometry.

Axis convention (array order, slowest..fastest):
  - Cartesian: (z, y, x); sweeps happen along each array axis.
  - Cylindrical axisymmetric: (R, z)  [PION's (Rcyl, Zcyl)]; radial axis = 0.
  - Spherical 1D: (r,); radial axis = 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import SimConfig
from .constants import Coord


@dataclasses.dataclass(frozen=True)
class AxisGeom:
    """Per-axis geometry, padded with ``ng`` ghost cells on both sides.

    All arrays have length ``n + 2*ng`` except the divergence coefficients
    which cover interior cells only (length ``n``).
    """

    pos: np.ndarray       # geometric cell-center coordinate
    com: np.ndarray       # center-of-volume ("center of mass") coordinate
                          #   cyl-R: R + dR^2/(12 R)   (VectorOps.h:414-419)
                          #   sph-r: r(1+d^2/4)/(1+d^2/12), d=dR/r (VectorOps_spherical.h:188)
    del_n: np.ndarray     # (low-face position)  - com : edge-state offset
    del_p: np.ndarray     # (high-face position) - com
    div_cn: np.ndarray    # interior: dudt = div_cn*F_lo - div_cp*F_hi
    div_cp: np.ndarray    #   cart: 1/dx; cyl-R: 2 r∓/(r+²-r-²); sph: 3 r∓²/(r+³-r-³)
    is_radial: bool


@dataclasses.dataclass(frozen=True)
class Geometry:
    axes: Tuple[AxisGeom, ...]
    cell_volume: np.ndarray   # interior-cell volumes, broadcastable to grid shape
    dx: float
    _tensors: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def axis_tensors(self, axis: int, dtype, device) -> dict:
        """The 1D arrays of ``axes[axis]`` as tensors of ``dtype`` on
        ``device``.  The numpy arrays are float64 or float32 by config; a
        bare ``torch.as_tensor`` of a float64 one would promote a float32
        state, so they are cast here once and cached per geometry."""
        import torch

        key = (axis, dtype, str(device))
        if key not in self._tensors:
            g = self.axes[axis]
            self._tensors[key] = {
                name: torch.as_tensor(getattr(g, name)).to(
                    dtype=dtype, device=device)
                for name in ("pos", "com", "del_n", "del_p", "div_cn",
                             "div_cp")}
        return self._tensors[key]

    @property
    def radial_axis(self) -> Optional[int]:
        for i, a in enumerate(self.axes):
            if a.is_radial:
                return i
        return None


def make_geometry(cfg: SimConfig) -> Geometry:
    dx = cfg.dx
    ng = cfg.ng
    axes = []
    for ax in range(cfg.ndim):
        n = cfg.shape[ax]
        pos = cfg.cell_centers(ax, padded=True)
        radial = (cfg.coords is Coord.CYLINDRICAL and ax == 0) or (
            cfg.coords is Coord.SPHERICAL
        )
        if not radial:
            com = pos
            del_n = np.full_like(pos, -0.5 * dx)
            del_p = np.full_like(pos, +0.5 * dx)
            div_cn = np.full((n,), 1.0 / dx, dtype=cfg.np_dtype)
            div_cp = div_cn
        else:
            rp = pos + 0.5 * dx
            rn = pos - 0.5 * dx
            if cfg.coords is Coord.CYLINDRICAL:
                com = pos + dx * dx / 12.0 / pos
                denom = rp * rp - rn * rn
                cn_full = 2.0 * rn / denom
                cp_full = 2.0 * rp / denom
            else:  # spherical
                d2 = (dx / pos) ** 2
                com = pos * (1.0 + 0.25 * d2) / (1.0 + d2 / 12.0)
                denom = (rp**3 - rn**3) / 3.0
                cn_full = rn * rn / denom
                cp_full = rp * rp / denom
            del_n = rn - com
            del_p = rp - com
            div_cn = cn_full[ng : ng + n].astype(cfg.np_dtype)
            div_cp = cp_full[ng : ng + n].astype(cfg.np_dtype)
        axes.append(
            AxisGeom(
                pos=pos.astype(cfg.np_dtype),
                com=com.astype(cfg.np_dtype),
                del_n=del_n.astype(cfg.np_dtype),
                del_p=del_p.astype(cfg.np_dtype),
                div_cn=div_cn,
                div_cp=div_cp,
                is_radial=radial,
            )
        )

    # Cell volumes (interior), broadcastable over the grid shape.  Kept in
    # float64 numpy regardless of cfg.dtype: cgs cylindrical volumes
    # (~2 pi R dR dz ~ 1e52) overflow float32; consumers either stay on the
    # host (conservation audits) or normalize to relative weights before
    # casting (NG restriction).
    dx64 = float(dx)
    if cfg.coords is Coord.CARTESIAN:
        vol = np.full((1,) * cfg.ndim, dx64**cfg.ndim, dtype=np.float64)
    elif cfg.coords is Coord.CYLINDRICAL:
        # V = pi*((R+)^2-(R-)^2)*dz (VectorOps.cpp:688-697), R = array axis 0
        r = axes[0].pos[ng : ng + cfg.shape[0]].astype(np.float64)
        v_r = np.pi * ((r + 0.5 * dx64) ** 2 - (r - 0.5 * dx64) ** 2) * dx64
        vol = v_r[:, None]
    else:  # spherical
        r = axes[0].pos[ng : ng + cfg.shape[0]].astype(np.float64)
        vol = (4.0 * np.pi / 3.0) * ((r + 0.5 * dx64) ** 3
                                     - (r - 0.5 * dx64) ** 3)
    return Geometry(axes=tuple(axes), cell_volume=vol, dx=dx)


