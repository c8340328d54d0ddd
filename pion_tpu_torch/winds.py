"""Stellar-wind internal boundary regions.

Counterpart of the reference wind machinery
(reference: source/grid/stellar_wind_BC.cpp: add_source/add_cell carve a
sphere of radius R around each source and every step overwrite the cells
inside with the free-wind state; stellar_wind_evolution interpolates
time-dependent wind parameters from stellar-evolution tables,
stellar_wind_BC.cpp:1240-1400).

Here the carved region is a boolean mask plus geometry (distance,
direction cosines, co-latitude), and the overwrite is a single
``torch.where`` applied after every partial update — the vectorized
equivalent of ``BC_update_STWIND``
(reference: boundaries/stellar_wind_boundaries.cpp).  ``apply`` returns a
new tensor; the state it is given is never written.

Wind models (``WindSource.model``):

- ``"iso"``    — isotropic wind, optionally rotating/magnetized
  (reference: stellar_wind_BC.cpp set_wind_cell_reference_state:375-640).
- ``"angle"``  — latitude-dependent rotating-star wind following the
  omega-slow-wind solution (reference: grid/stellar_wind_angle.cpp
  fn_phi/fn_alpha/fn_delta/fn_v_inf/fn_density:290-440).  The reference
  tabulates alpha/delta on (omega, theta, Teff) grids and tri-linearly
  interpolates; the closed-form functions are cheap elementwise ops, so
  they are evaluated directly (the Simpson quadrature for delta is a fixed
  230-point vectorized sum) — no tables needed.
- ``"latdep"`` — simplified latitude profile rho ~ (1 + A f(theta)),
  f = sin(theta)(1-Omega sin th)^xi, normalised so the total mass-loss
  rate equals Mdot (reference: grid/stellar_wind_latdep.cpp
  f/integrate_Simpson/interp_density:172-280).

Orbiting sources move on an ellipse in the physical x-y plane
(reference: boundaries/stellar_wind_boundaries.cpp:280-330); because the
position is time-dependent the region mask is recomputed from the position
at every call.

Numbers and types.  The wind parameters (Mdot, v_inf, T_w, R*, v_rot,
v_crit) are host floats for a source without an evolution table and 0-d
float64 tensors on the state's device for one with a table; the geometry
fields are tensors of the state's dtype.  A 0-d tensor does not promote a
field, so a float32 state stays float32.  Formulas are grouped as products
of factors that float32 can hold (``(mdot / (4 pi v)) / r / r``, never
``mdot / (4 pi r^2 v)``: ``r^2 v ~ 1e43`` cgs overflows).

The free-wind state of a source that neither orbits nor evolves does not
depend on time: it is computed once per dtype and device and kept, so that
``apply`` is one ``torch.where`` a call.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import SimConfig
from .constants import K_B, M_P, YEAR, Eqn
from .grid import Geometry

C_GAMMA = 0.35  # reference: stellar_wind_angle.cpp:59 c_gamma


# ---------------------------------------------------------------------------
# small helpers: scalars may be host numbers or tensors
# ---------------------------------------------------------------------------

def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _min(a, b: float):
    return torch.clamp(a, max=b) if _is_t(a) else min(a, b)


def _max(a, b: float):
    return torch.clamp(a, min=b) if _is_t(a) else max(a, b)


def _clip(a, lo: float, hi: float):
    return torch.clamp(a, lo, hi) if _is_t(a) else min(max(a, lo), hi)


def _sin(a):
    return torch.sin(a) if _is_t(a) else float(np.sin(a))


def _cos(a):
    return torch.cos(a) if _is_t(a) else float(np.cos(a))


# host arrays made into tensors inside a step, kept per dtype and device
# (with the array itself, so that its id is not taken again): a step copies
# nothing from the host, and a CUDA graph of several steps can be recorded
_KEPT: Dict = {}


def _kept(a, dtype, device) -> torch.Tensor:
    key = (id(a), dtype, device)
    if key not in _KEPT:
        _KEPT[key] = (a, torch.as_tensor(np.ascontiguousarray(a),
                                         dtype=dtype, device=device))
    return _KEPT[key][1]


def interp(x, xp, fp):
    """Piecewise-linear interpolation of the table ``(xp, fp)`` at ``x``,
    constant outside the table — ``numpy.interp``.  A host number gives a
    host float (float64); a tensor gives a tensor of its dtype on its
    device (the table is copied there once and kept)."""
    if not _is_t(x):
        return float(np.interp(x, np.asarray(xp, dtype=np.float64),
                               np.asarray(fp, dtype=np.float64)))
    xt = _kept(xp, x.dtype, x.device)
    ft = _kept(fp, x.dtype, x.device)
    n = xt.numel()
    i = torch.clamp(torch.searchsorted(xt, x.contiguous(), right=True),
                    1, n - 1)
    df = ft[i] - ft[i - 1]
    dx = xt[i] - xt[i - 1]
    delta = x - xt[i - 1]
    flat = dx.abs() <= torch.finfo(x.dtype).tiny
    f = torch.where(flat, ft[i - 1],
                    ft[i - 1] + (delta / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xt[0], ft[0], f)
    return torch.where(x > xt[-1], ft[-1], f)


# ---------------------------------------------------------------------------
# Latitude-dependence model functions (broadcast over theta grids)
# ---------------------------------------------------------------------------

_BETA_T = np.array([3600.0, 6000.0, 8000.0, 10000.0, 20000.0, 22000.0])
_BETA_B = np.array([0.125, 0.5, 0.7, 1.3, 1.3, 2.6])


def beta_eldridge(teff):
    """v_inf/v_esc ratio vs Teff, Eldridge et al. (2006) Table 1
    (reference: stellar_wind_BC.cpp stellar_wind::beta:820-866); constant
    extrapolation outside [3600, 22000] K as in the reference."""
    return interp(teff, _BETA_T, _BETA_B)


def fn_phi(omega, theta, teff):
    """Streamline deflection angle phi' (reference:
    stellar_wind_angle.cpp:285-295)."""
    s = _sin(theta)
    ans = (omega / (22.0 * np.sqrt(2.0) * beta_eldridge(teff))) * s \
        * (1.0 - omega * s) ** (-C_GAMMA)
    return _min(ans, 0.5 * np.pi * (1.0 - 1.0e-6))


def fn_alpha(omega, theta, teff):
    """Mass-flux concentration factor alpha (reference:
    stellar_wind_angle.cpp:305-315); the cot^2 term -> cos^2(theta) limit
    on the pole is finite, so clip theta away from 0 for safe division."""
    theta = _max(theta, 1.0e-5)
    phi = fn_phi(omega, theta, teff)
    s = _sin(theta)
    cot2 = (_cos(theta) / s) ** 2
    return 1.0 / (_cos(phi)
                  + cot2 * (1.0 + C_GAMMA * omega * s / (1.0 - omega * s))
                  * phi * _sin(phi))


def _simpson(lo: float, hi: float, npt: int, like):
    """Nodes, weights and spacing of the fixed-grid Simpson rule; float64
    on the CPU unless ``like`` is a tensor (then its dtype and device)."""
    h = (hi - lo) / npt
    dtype, device = ((like.dtype, like.device) if _is_t(like)
                     else (torch.float64, torch.device("cpu")))
    key = ("simpson", lo, hi, npt, dtype, device)
    if key not in _KEPT:
        w = np.full(npt + 1, 2.0)
        w[1::2] = 4.0
        w[0] = w[-1] = 1.0
        _KEPT[key] = (None, torch.as_tensor(w, dtype=dtype, device=device))
    th = lo + h * torch.arange(npt + 1, dtype=dtype, device=device)
    return th, _KEPT[key][1], h


def fn_delta(omega, teff, xi, npt: int = 230):
    """Normalisation so the lat-dep density integrates to Mdot: delta =
    2 / int_0^{pi/2} alpha (1-om sin th)^xi sin th dth, fixed-grid Simpson
    (reference: stellar_wind_angle.cpp fn_delta + integrate_Simpson:240-333).
    Host numbers give a host float."""
    th, w, h = _simpson(0.001, 0.5 * np.pi, npt,
                        omega if _is_t(omega) else teff)
    f = fn_alpha(omega, th, teff) \
        * (1.0 - omega * torch.sin(th)) ** xi * torch.sin(th)
    out = 2.0 / (torch.sum(w * f) * h / 3.0)
    return out if _is_t(omega) or _is_t(teff) else float(out)


def fn_v_inf(omega, vinf, theta):
    """Latitude-dependent terminal velocity, floored at 0.5 km/s
    (reference: stellar_wind_angle.cpp:342-353)."""
    omega = _min(omega, 0.999)
    return _max(vinf * (1.0 - omega * _sin(theta)) ** C_GAMMA, 0.5e5)


def fn_density_angle(omega, vinf, mdot, r, theta, teff, xi):
    """Omega-slow-wind density (reference: stellar_wind_angle.cpp
    fn_density:361-377).  Grouped as (mdot/8pi v) / r / r so no
    intermediate overflows float32 (r^2*v ~ 1e43 cgs would)."""
    return (mdot / (8.0 * np.pi * fn_v_inf(omega, vinf, theta))
            * fn_alpha(omega, theta, teff) * fn_delta(omega, teff, xi)
            * (1.0 - omega * _sin(theta)) ** xi) / r / r


def latdep_f(theta, omega, xi):
    """f(theta, Omega) = sin(theta)(1 - Omega sin theta)^xi
    (reference: stellar_wind_latdep.cpp:172-178)."""
    return _sin(theta) * (1.0 - omega * _sin(theta)) ** xi


def latdep_norm(omega, xi, npt: int = 1000):
    """int_0^{pi/2} f sin(theta) dtheta (reference:
    stellar_wind_latdep.cpp:150-157 norm_vec via integrate_Simpson).  A host
    ``omega`` gives a host float."""
    th, w, h = _simpson(0.0, 0.5 * np.pi, npt, omega)
    out = torch.sum(w * latdep_f(th, omega, xi) * torch.sin(th)) * h / 3.0
    return out if _is_t(omega) else float(out)


# ---------------------------------------------------------------------------
# Source description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindEvolution:
    """Time-interpolated wind parameters (reference:
    stellar_wind_evolution::update_source, stellar_wind_BC.h:391,501;
    table format 'time M L Teff Mdot vrot vcrit vinf',
    stellar_wind_BC.cpp:1034).  Columns are linear-interpolated in time;
    times in seconds."""

    time: np.ndarray
    mdot: np.ndarray        # g/s
    vinf: np.ndarray        # cm/s
    t_wind: np.ndarray      # K (doubles as Teff for lat-dep models)
    rstar: np.ndarray       # cm
    v_rot: Optional[np.ndarray] = None   # cm/s
    vcrit: Optional[np.ndarray] = None   # cm/s

    def at(self, t) -> Dict:
        """The columns at time ``t``: host floats for a host ``t``, 0-d
        tensors of ``t``'s dtype on its device for a tensor."""
        out = {
            "mdot": interp(t, self.time, self.mdot),
            "vinf": interp(t, self.time, self.vinf),
            "t_wind": interp(t, self.time, self.t_wind),
            "rstar": interp(t, self.time, self.rstar),
        }
        if self.v_rot is not None:
            out["v_rot"] = interp(t, self.time, self.v_rot)
        if self.vcrit is not None:
            out["vcrit"] = interp(t, self.time, self.vcrit)
        return out


def load_evolution_file(path: str) -> "WindEvolution":
    """Read a stellar-evolution table for an evolving wind source
    (reference: stellar_wind_BC.cpp:1026-1095 read_evolution_file — skip
    two header lines; CGS columns ``time M L Teff Mdot vrot vcrit vinf
    [X_H X_He X_C X_N X_O X_Z X_D]``; R* from the Stefan-Boltzmann law)."""
    SIGMA_SB = 5.670367e-5  # reference: constants.h:55
    rows = []
    with open(path) as f:
        lines = f.readlines()[2:]
    for line in lines:
        parts = line.split()
        if len(parts) >= 8:
            rows.append([float(x) for x in parts[:8]])
    if not rows:
        raise ValueError(f"no data rows in evolution file {path}")
    a = np.asarray(rows)
    time, _mass, lumi, teff = a[:, 0], a[:, 1], a[:, 2], a[:, 3]
    mdot, vrot, vcrit, vinf = a[:, 4], a[:, 5], a[:, 6], a[:, 7]
    rstar = np.sqrt(lumi / (4.0 * np.pi * SIGMA_SB * teff**4))
    return WindEvolution(time=time, mdot=mdot, vinf=vinf, t_wind=teff,
                         rstar=rstar, v_rot=vrot, vcrit=vcrit)


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
    evolution: Optional[WindEvolution] = None
    # latitude-dependent models (reference: stellar_wind_angle/latdep.cpp)
    model: str = "iso"                # "iso" | "angle" | "latdep"
    vcrit: float = 0.0                # critical rotation speed [cm/s]
    xi: float = -0.43                 # equatorial-enhancement exponent
    md0: float = 0.0                  # non-rotating Mdot for "latdep" (g/s)
    # orbit (reference: stellar_wind_boundaries.cpp:280-330; period in years,
    # periastron vector in the physical x-y plane)
    orb_period: float = 0.0
    eccentricity_fac: float = 1.0
    periastron: Tuple[float, float] = (0.0, 0.0)
    # index into the tracer tuple of the H+ fraction, set from Tw
    # (reference: stellar_wind_angle.cpp:646-660)
    hplus: int = -1

    @property
    def orbits(self) -> bool:
        return self.orb_period != 0.0


# ---------------------------------------------------------------------------
# The boundary region
# ---------------------------------------------------------------------------

class _TorchOps:
    """The handful of array functions ``WindBC._geometry`` needs, for
    tensors (numpy serves the static sources)."""

    sqrt = staticmethod(torch.sqrt)
    abs = staticmethod(torch.abs)
    arctan2 = staticmethod(torch.atan2)
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def maximum(a, b: float):
        return torch.clamp(a, min=b)


class WindBC:
    """Precomputed wind-region geometry + the per-step overwrite."""

    def __init__(self, cfg: SimConfig, geom: Geometry, src: WindSource):
        self.cfg = cfg
        self.src = src
        self.geom = geom
        ng = cfg.ng
        centers = [g.pos[ng:-ng] for g in geom.axes]
        self._grids = np.meshgrid(*centers, indexing="ij")
        # the region about the source's initial position, as numpy arrays:
        # all of it for a static source, the mask (for inspection) for an
        # orbiting one, whose geometry is made anew at each call
        self._geo_np = self._geometry(np, src.position, self._grids)
        self._cache: Dict = {}

    def block(self, sl) -> "WindBC":
        """This region restricted to one block of a sharded grid (``sl``:
        the block's global slices): its cell positions and geometry are the
        whole grid's, sliced, never rebuilt from the block's own
        coordinates, so a block's wind state is the whole grid's there."""
        blk = copy.copy(self)
        blk._grids = [g[sl] for g in self._grids]
        blk._geo_np = {k: v[sl] for k, v in self._geo_np.items()}
        blk._cache = {}
        return blk

    # -- geometry ----------------------------------------------------------
    def _geometry(self, xp, position, grids):
        """Distance/direction/theta fields about ``position`` (array-order).
        ``xp`` is numpy for static sources, :class:`_TorchOps` for moving
        (orbiting) ones."""
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

    def _fields(self, like: torch.Tensor, t=None) -> Dict:
        """The geometry as tensors of ``like``'s dtype on its device: kept
        per dtype and device for a static source, made from the position at
        ``t`` for an orbiting one."""
        if self.src.orbits and t is not None:
            key = ("grids", like.dtype, like.device)
            if key not in self._cache:
                self._cache[key] = [
                    torch.as_tensor(g).to(dtype=like.dtype,
                                          device=like.device)
                    for g in self._grids]
            return self._geometry(_TorchOps, self.position_at(t),
                                  self._cache[key])
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

    def position_at(self, t):
        """Elliptical orbit in the physical x-y plane (reference:
        stellar_wind_boundaries.cpp:285-320, rotation matrix from the
        periastron vector; period in years).  Returns array-order coords;
        the moving ones are tensors when ``t`` is one."""
        s = self.src
        px, py = s.periastron
        cos_a = -np.sign(px) * np.cos(np.arctan2(py, px if px != 0.0 else 1.0))
        sin_a = np.sin(-np.sign(py if py != 0.0 else 1.0) * np.arccos(cos_a))
        a = np.hypot(px, py) * s.eccentricity_fac
        e = a * (s.eccentricity_fac - 1.0) / s.eccentricity_fac
        b = np.sqrt(max(a * a - e * e, 0.0))
        ang = 2.0 * np.pi * t / (s.orb_period * YEAR)
        sin_t, cos_t = _sin(ang), _cos(ang)
        x0 = s.position[-1]
        y0 = s.position[-2] if self.cfg.ndim > 1 else 0.0
        x = x0 - a * cos_a + cos_a * a * cos_t - sin_a * b * sin_t
        y = y0 - a * sin_a + sin_a * a * cos_t + cos_a * b * sin_t
        pos = list(s.position)
        pos[-1] = x
        if self.cfg.ndim > 1:
            pos[-2] = y
        return tuple(pos)

    # -- parameters at time t ----------------------------------------------
    def _params(self, t):
        s = self.src
        par = dict(mdot=s.mdot, vinf=s.vinf, t_wind=s.t_wind, rstar=s.rstar,
                   v_rot=s.v_rot, vcrit=s.vcrit)
        if s.evolution is not None:
            par.update(s.evolution.at(t))
        return par

    def _omega(self, par):
        vc = par["vcrit"]
        if isinstance(vc, (int, float)) and vc == 0.0:
            return 0.0
        return _min(par["v_rot"] / vc, 0.999)

    # -- the free-wind state -------------------------------------------------
    def wind_state(self, P, t):
        """Free-wind primitive state on the full grid (values only used
        under the mask) — reference: set_wind_cell_reference_state
        (stellar_wind_BC.cpp:375-640, stellar_wind_angle.cpp:460-660,
        stellar_wind_latdep.cpp:286-430).  ``P`` gives the dtype and the
        device; ``t`` may be a host number or a 0-d tensor."""
        s = self.src
        static = not s.orbits and s.evolution is None
        key = ("W", P.dtype, P.device)
        if static and key in self._cache:
            return self._cache[key]
        if _is_t(t):
            # table and orbit arithmetic at float64 whatever the state is
            t = t.to(dtype=torch.float64, device=P.device)
        W = self._wind_state(P, t, self._fields(P, t))
        if static:
            self._cache[key] = W
        return W

    def _wind_state(self, P, t, geo):
        cfg, s = self.cfg, self.src
        g = cfg.gamma
        par = self._params(t)
        d, nx, ny, nz = geo["dist"], geo["nx"], geo["ny"], geo["nz"]
        theta, inner = geo["theta"], geo["inner"]

        if s.model == "angle":
            om = self._omega(par)
            teff = par["t_wind"]
            rho = fn_density_angle(om, par["vinf"], par["mdot"], d,
                                   theta, teff, s.xi)
            rho_star = fn_density_angle(om, par["vinf"], par["mdot"],
                                        par["rstar"], theta, teff, s.xi)
            # p = Tw kB/mp rho_star^(1-g) rho^g (stellar_wind_angle.cpp:495-505)
            # regrouped as rho_star*(rho/rho_star)^g: rho^g alone underflows
            # float32 (1e-24^(5/3) ~ 1e-40)
            pg = (K_B * par["t_wind"] / M_P) * rho_star \
                * (rho / rho_star) ** g
            vmag = fn_v_inf(om, par["vinf"], theta)
        elif s.model == "latdep":
            om = self._omega(par)
            md0 = s.md0 if s.md0 > 0.0 else s.mdot
            vmag = par["vinf"] * (1.0 - _min(om, 0.999)
                                  * torch.sin(theta)) ** C_GAMMA
            A = (par["mdot"] / md0 - 1.0) / latdep_norm(om, s.xi)
            rho = (md0 / (4.0 * np.pi * vmag)) \
                * (1.0 + A * latdep_f(theta, om, s.xi)) / d / d
            # p = Tw kB/mp (rho (d/Rstar)^2)^(1-g) rho^g, which simplifies
            # to Tw kB/mp rho (Rstar/d)^(2(g-1)) — float32-safe
            # (stellar_wind_latdep.cpp:330-338)
            pg = (K_B * par["t_wind"] / M_P) * rho \
                * (par["rstar"] / d) ** (2.0 * (g - 1.0))
        else:
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
        elif cfg.ndim == 3 and (s.v_rot != 0.0 or s.evolution is not None):
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
        if self.src.orbits:
            if _is_t(t):
                t = t.to(dtype=torch.float64, device=P.device)
            geo = self._fields(P, t)
            return torch.where(geo["mask"], self._wind_state(P, t, geo), P)
        return torch.where(self.mask_like(P), self.wind_state(P, t), P)


def make_wind_bcs(cfg: SimConfig, geom: Geometry, sources):
    return [WindBC(cfg, geom, s) for s in sources]
