"""Stellar-wind internal boundary regions.

Counterpart of the reference wind machinery
(reference: source/grid/stellar_wind_BC.cpp: add_source/add_cell carve a
sphere of radius R around each source and every step overwrite the cells
inside with the free-wind state).

Here the carved region is a boolean mask plus geometry (distance,
direction cosines, co-latitude), and the overwrite is a single
``torch.where`` applied after every partial update — the vectorized
equivalent of ``BC_update_STWIND``
(reference: boundaries/stellar_wind_boundaries.cpp).  ``apply`` returns a
new tensor; the state it is given is never written.

Kept in this copy: the isotropic wind, optionally rotating and magnetized
(reference: stellar_wind_BC.cpp set_wind_cell_reference_state:375-640), of
a source that neither orbits nor evolves.  The latitude-dependent models,
evolution tables and orbits are left out.

Numbers and types.  The wind parameters (Mdot, v_inf, T_w, R*, v_rot) are
host floats; the geometry fields are tensors of the state's dtype.  Formulas are grouped as products
of factors that float32 can hold (``(mdot / (4 pi v)) / r / r``, never
``mdot / (4 pi r^2 v)``: ``r^2 v ~ 1e43`` cgs overflows).

The free-wind state does not depend on time: it is computed once per dtype
and device and kept, so that ``apply`` is one ``torch.where`` a call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .config import SimConfig
from .constants import K_B, M_P, Eqn
from .grid import Geometry


# ---------------------------------------------------------------------------
# small helpers: scalars may be host numbers or tensors
# ---------------------------------------------------------------------------

def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _max(a, b: float):
    return torch.clamp(a, min=b) if _is_t(a) else max(a, b)


def _clip(a, lo: float, hi: float):
    return torch.clamp(a, lo, hi) if _is_t(a) else min(max(a, lo), hi)


@dataclasses.dataclass(frozen=True)
class WindSource:
    """One wind source (reference: stellarwind_params, sim_params.h:129-157)."""

    position: Tuple[float, ...]       # array-order coordinates
    radius: float                     # boundary-region radius [cm]
    mdot: float                       # mass-loss rate [g/s]
    vinf: float                       # terminal velocity (at pole) [cm/s]
    t_wind: float = 1.0e4             # wind temperature at the stellar surface
    rstar: float = 7.0e10             # stellar radius [cm]
    v_rot: float = 0.0                # equatorial rotation speed [cm/s]
    b_star: float = 0.0               # surface split-monopole field [G]
    tracers: Tuple[float, ...] = ()   # tracer values of the wind material
    # index into the tracer tuple of the H+ fraction, set from Tw
    # (reference: stellar_wind_angle.cpp:646-660)
    hplus: int = -1

# ---------------------------------------------------------------------------
# The boundary region
# ---------------------------------------------------------------------------

class WindBC:
    """Precomputed wind-region geometry + the per-step overwrite."""

    def __init__(self, cfg: SimConfig, geom: Geometry, src: WindSource):
        self.cfg = cfg
        self.src = src
        self.geom = geom
        ng = cfg.ng
        centers = [g.pos[ng:-ng] for g in geom.axes]
        self._grids = np.meshgrid(*centers, indexing="ij")
        # the region about the source's position, as numpy arrays
        self._geo_np = self._geometry(np, src.position, self._grids)
        self._cache: Dict = {}

    # -- geometry ----------------------------------------------------------
    def _geometry(self, xp, position, grids):
        """Distance/direction/theta fields about ``position`` (array-order),
        with the array functions of ``xp`` (numpy)."""
        cfg, src = self.cfg, self.src
        nd = cfg.ndim
        d_arr = [g - p for g, p in zip(grids, position)]
        dist = xp.sqrt(sum(dd * dd for dd in d_arr))
        dist = xp.maximum(dist, 0.1 * self.geom.dx)
        mask = dist <= src.radius
        inner = (dist < 0.75 * src.radius) & (nd > 1)
        # physical-axis components: x = offset along the LAST array axis
        phys = [d_arr[nd - 1 - k] if k < nd else xp.zeros_like(dist)
                for k in range(3)]
        nx, ny, nz = (p / dist for p in phys)
        # co-latitude theta measured from the rotation axis
        # (reference: stellar_wind_BC.cpp:289-312: 2D axisymmetric has the
        # symmetry (rotation) axis along XX; 3D rotation axis is z)
        if nd == 1:
            theta = xp.zeros_like(dist)
        elif nd == 2:
            theta = xp.arctan2(xp.abs(ny), xp.abs(nx))
        else:
            theta = xp.arctan2(xp.sqrt(nx * nx + ny * ny), xp.abs(nz))
        return dict(mask=mask, inner=inner, dist=dist,
                    nx=nx, ny=ny, nz=nz, theta=theta)

    def _fields(self, like: torch.Tensor) -> Dict:
        """The geometry as tensors of ``like``'s dtype on its device, kept
        per dtype and device."""
        key = ("geo", like.dtype, like.device)
        if key not in self._cache:
            self._cache[key] = {
                k: torch.as_tensor(v).to(
                    dtype=torch.bool if v.dtype == np.bool_ else like.dtype,
                    device=like.device)
                for k, v in self._geo_np.items()}
        return self._cache[key]

    @property
    def mask(self) -> torch.Tensor:
        """The region about the source's initial position (CPU, bool)."""
        return torch.as_tensor(self._geo_np["mask"])

    def mask_like(self, like: torch.Tensor) -> torch.Tensor:
        """The static region mask on ``like``'s device."""
        return self._fields(like)["mask"]

    # -- the free-wind state -------------------------------------------------
    def wind_state(self, P, t):
        """Free-wind primitive state on the full grid (values only used
        under the mask) — reference: set_wind_cell_reference_state
        (stellar_wind_BC.cpp:375-640).  ``P`` gives the dtype and the
        device; the state does not depend on ``t``."""
        key = ("W", P.dtype, P.device)
        if key not in self._cache:
            self._cache[key] = self._wind_state(P, self._fields(P))
        return self._cache[key]

    def _wind_state(self, P, geo):
        cfg, s = self.cfg, self.src
        g = cfg.gamma
        par = dict(mdot=s.mdot, vinf=s.vinf, t_wind=s.t_wind, rstar=s.rstar,
                   v_rot=s.v_rot)
        d, nx, ny, nz = geo["dist"], geo["nx"], geo["ny"], geo["nz"]
        inner = geo["inner"]

        rho = par["mdot"] / (par["vinf"] * 4.0 * np.pi) / d / d
        # adiabatic wind: T=Tw at the stellar surface; grouped as
        # rho_star*(rho/rho_star)^g = rho*(rstar/d)^(2(g-1)) since
        # rho ~ d^-2 exactly — float32-safe (rho^g alone underflows)
        pg = (K_B * par["t_wind"] / M_P) * rho \
            * (par["rstar"] / d) ** (2.0 * (g - 1.0))
        vmag = par["vinf"]

        vx = vmag * nx
        vy = vmag * ny
        vz = vmag * nz
        if cfg.ndim == 2:
            # axisymmetric: VZ carries the rotational (phi) component
            # (reference: stellar_wind_BC.cpp:446 p[VZ] = v_rot*Rstar*y/d^2)
            vz = par["v_rot"] * par["rstar"] * ny / d
        elif cfg.ndim == 3 and s.v_rot != 0.0:
            # J parallel to z (reference: :565-570)
            vx = vx - par["v_rot"] * par["rstar"] * ny / d
            vy = vy + par["v_rot"] * par["rstar"] * nx / d
        # deep interior: rho and p kept inert (reference: :382-388 sets only
        # RO/PG to 1e-31 when dist < 0.75*radius in multi-D)
        out = [torch.where(inner, 1.0e-31, rho),
               torch.where(inner, 1.0e-31, pg), vx, vy, vz]
        if cfg.eqn.is_mhd:
            # split monopole + toroidal (Parker-spiral) rotation term
            # (reference: stellar_wind_BC.cpp:505-560,
            #  stellar_wind_angle.cpp:579-640)
            b_s = par.get("b_star", s.b_star) / np.sqrt(4.0 * np.pi)
            d_s = par["rstar"] / d
            d_2 = d_s * d_s
            bt = (par["v_rot"] / _max(vmag, 1.0)) * b_s * d_s
            if cfg.ndim <= 2:
                # 2D axisymmetric: x = symmetry axis, y = cyl radius
                bx = b_s * d_2 * torch.abs(nx)
                by = torch.sign(nx) * ny * b_s * d_2
                bz = -torch.sign(nx) * bt * ny
            else:
                sz = torch.sign(nz)
                bx = sz * nx * b_s * d_2
                by = sz * ny * b_s * d_2
                bz = b_s * d_2 * torch.abs(nz)
                btor = -sz * bt * torch.sqrt(nx * nx + ny * ny)
                bx = bx - btor * ny
                by = by + btor * nx
            out += [bx, by, bz]
            if cfg.eqn is Eqn.GLM:
                out += [torch.zeros_like(rho)]
        for i, tv in enumerate(s.tracers):
            if i == s.hplus:
                # H+ fraction from wind temperature, linear ramp 1e4..1.5e4 K
                # (reference: stellar_wind_angle.cpp:646-660)
                yion = _clip((par["t_wind"] - 1.0e4) / 5.0e3, 1.0e-7, 1.0)
                out.append(torch.zeros_like(rho) + yion)
            else:
                out.append(torch.full_like(rho, tv))
        while len(out) < cfg.nvar:
            out.append(torch.zeros_like(rho))
        return torch.stack([
            (o if _is_t(o) else torch.full_like(rho, o)).to(P.dtype).expand(
                rho.shape) for o in out[: cfg.nvar]])

    def apply(self, P, t):
        """``P`` with the wind region overwritten, as a new tensor."""
        return torch.where(self.mask_like(P), self.wind_state(P, t), P)


def make_wind_bcs(cfg: SimConfig, geom: Geometry, sources):
    return [WindBC(cfg, geom, s) for s in sources]
