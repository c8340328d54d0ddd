"""MPv7: two-temperature isothermal photoionization module.

Counterpart of the JAX package's ``pion_tpu/microphysics/mpv7.py``
(reference: source/microphysics/MPv7.cpp): the gas temperature is a function
of the ionization fraction only, T = T_lo + x*(T_hi - T_lo) (:235), so only
the ion fraction is integrated and the pressure is slaved to T(x).  Used for
simple H II region expansion tests (Iliev et al. 2009 test 5 analogues with
fixed temperatures).

Plain PyTorch on any device.  It is not an :class:`~.mpv3.MPv3`, so the
MPv3 kernels (B3/B4) never take it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO
from . import tables as TB
from .base import MicrophysicsBase
from .mpv3 import E_MONO, MIN_NEUTRAL, SIGMA0


@dataclasses.dataclass(frozen=True)
class MPv7Config:
    tracer_slot: int
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703
    metal_mass_frac: float = 0.0142     # >0.5 => molecular neutral medium
    t_lo: float = 1.0e2                 # neutral-gas temperature
    t_hi: float = 1.0e4                 # ionized-gas temperature
    ion_src: Optional[str] = "mono"
    n_idot: float = 0.0
    recomb_rate: float = 2.7e-13        # case-B at ~1e4 K (reference MPv7)

    @property
    def x_frac(self):
        return 1.0 - self.helium_mass_frac

    @property
    def mean_mass_per_h(self):
        return M_P / self.x_frac

    @property
    def mol(self):
        return 0.5 if self.metal_mass_frac > 0.5 else 1.0


class MPv7(MicrophysicsBase):
    name = "MPv7"

    def __init__(self, mpc: MPv7Config):
        self.mpc = mpc

    def n_H(self, rho):
        return rho / (M_P / self.mpc.x_frac)

    def n_tot(self, nH, x):
        c = self.mpc
        nnt = c.mol + 0.25 * c.helium_mass_frac / c.x_frac
        # (reference: MPv7.cpp get_ntot with JM_NELEC=JM_NION=1)
        return ((1.0 - x) * c.mol + (nnt - c.mol) + x * 2.0) * nH

    def t_of_x(self, x):
        return self.mpc.t_lo + x * (self.mpc.t_hi - self.mpc.t_lo)

    def temperature(self, P, cfg: SimConfig):
        return self.t_of_x(P[self.mpc.tracer_slot])

    def set_temp(self, P, T, cfg: SimConfig):
        """The temperature is slaved to x: the pressure is reset to that of
        T(x), whatever ``T`` asks.  Returns a new tensor."""
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        p = self.n_tot(nH, x) * K_B * self.t_of_x(x)
        return torch.cat([P[:PG], p[None], P[PG + 1:]])

    def xdot(self, omx, nH, rt, with_derivative: bool = False):
        """d(1-x)/dt, and with ``with_derivative`` also its derivative by
        ``1-x`` (the JAX package takes it by ``jax.jvp``; here the chain
        rule is written out, branch by branch of the same selects)."""
        c = self.mpc
        x = 1.0 - omx
        ne = x * nH
        omx_dot = c.recomb_rate * x * ne
        d_omx_dot = -(c.recomb_rate * ne) - c.recomb_rate * x * nH
        if c.ion_src == "mono":
            frac = float(TB.hi_xsection_fractional(E_MONO))
            entries = rt.get("ion")
            if entries is None:
                entries = (rt,)
            for e in entries:  # summed per-source columns (rad_src_data.h)
                ddtau = nH * e["ds"] * SIGMA0 * frac
                dtau = nH * e["ds"] * omx * SIGMA0 * frac
                nv = e.get("nv", None)
                if nv is None:
                    nv = e["n_idot"] / e["vshell"]
                rate0 = nv * torch.exp(-e["tau0"] * frac)
                small = dtau < 1e-4
                rate = rate0 * torch.where(small, dtau,
                                           1.0 - torch.exp(-dtau)) / nH
                omx_dot = omx_dot - rate
                if with_derivative:
                    drate = rate0 * torch.where(
                        small, ddtau, torch.exp(-dtau) * ddtau) / nH
                    d_omx_dot = d_omx_dot - drate
        if with_derivative:
            return omx_dot, d_omx_dot
        return omx_dot

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        """Backward Euler with a bound-limited scalar Newton iteration in
        each of 8 substeps (the explicit form cannot equilibrate the stiff
        photoionization front); 10 iterations a substep, no test read back."""
        c = self.mpc
        nH = self.n_H(P[RO])
        omx = torch.clamp(1.0 - P[c.tracer_slot], MIN_NEUTRAL,
                          1.0 - MIN_NEUTRAL)
        h = dt / 8.0
        for _ in range(8):
            prev = omx
            y = omx
            for _i in range(10):
                f, df = self.xdot(y, nH, rt, with_derivative=True)
                g = y - prev - h * f
                dg = 1.0 - h * df
                step = g / torch.where(torch.abs(dg) > 1e-300, dg, 1.0)
                step = torch.clamp(step, -0.25, 0.25)
                y = torch.clamp(y - step, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
            omx = y
        x = 1.0 - omx
        p = self.n_tot(nH, x) * K_B * self.t_of_x(x)
        out = torch.cat([P[:PG], p[None], P[PG + 1:]])
        s = c.tracer_slot
        return torch.cat([out[:s], x[None], out[s + 1:]])

    def _timescales_impl(self, P, cfg: SimConfig, rt: Dict):
        """0.25 / |d(1-x)/dt|, the least over the cells as a 0-d tensor
        (``1e-100`` is 0 in float32, as in the JAX package without x64)."""
        c = self.mpc
        nH = self.n_H(P[RO])
        omx = torch.clamp(1.0 - P[c.tracer_slot], MIN_NEUTRAL,
                          1.0 - MIN_NEUTRAL)
        d = self.xdot(omx, nH, rt)
        return torch.min(0.25 / (torch.abs(d) + 1e-100))

    def default_rt(self, P) -> Dict:
        z = torch.zeros_like(P[RO])
        return {"tau0": z + 1.0e6, "ds": z, "vshell": z + 1.0e30,
                "n_idot": self.mpc.n_idot, "nv": z, "sv": z}
