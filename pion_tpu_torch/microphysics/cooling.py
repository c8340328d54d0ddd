"""Cooling-only microphysics: optically thin heating and cooling with no
species tracking (reference: source/microphysics/mp_only_cooling.cpp; the
curve menu includes the Sutherland & Dopita 1993 CIE curve of
cooling_SD93_cie.cpp:87-200, published data reproduced below).

:class:`MPOnlyCooling` is what the reference's 2D wind-bubble benchmarks
run (EP_cooling 8, ``WSS09_CIE_LINE_HEAT_COOL``).  Its curves are tabulated
once per component on a log-uniform temperature grid; a cell's lookup is an
arithmetic bin index and a row gather from one stacked table, kept on the
state's device per dtype, so a step copies nothing from the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO
from . import tables as TB
from .base import MicrophysicsBase

# Sutherland & Dopita (1993) solar-abundance CIE cooling curve
# (reference: cooling_SD93_cie.cpp:87-200; log-spaced 10^4..10^8.5 K).
_SD93_LOGT = np.linspace(4.0, np.log10(3.162278e8), 91)
_SD93_L = np.array([
    8.709636e-24, 3.467369e-23, 6.760830e-23, 1.202264e-22, 1.621810e-22,
    1.584893e-22, 1.380384e-22, 1.258925e-22, 1.318257e-22, 1.513561e-22,
    1.862087e-22, 2.344229e-22, 2.951209e-22, 3.801894e-22, 4.786301e-22,
    6.025596e-22, 7.244360e-22, 8.511380e-22, 9.772372e-22, 1.047129e-21,
    1.023293e-21, 9.549926e-22, 9.332543e-22, 9.772372e-22, 1.047129e-21,
    1.071519e-21, 1.096478e-21, 1.096478e-21, 1.023293e-21, 7.413102e-22,
    4.466836e-22, 2.818383e-22, 2.187762e-22, 1.949845e-22, 1.949845e-22,
    1.949845e-22, 1.737801e-22, 1.380384e-22, 1.174898e-22, 1.122018e-22,
    1.096478e-22, 1.096478e-22, 1.096478e-22, 1.122018e-22, 1.148154e-22,
    1.071519e-22, 8.511380e-23, 6.309573e-23, 4.897788e-23, 4.073803e-23,
    3.630781e-23, 3.311311e-23, 3.162278e-23, 2.951209e-23, 2.754229e-23,
    2.570396e-23, 2.511886e-23, 2.511886e-23, 2.570396e-23, 2.691535e-23,
    2.691535e-23, 2.570396e-23, 2.398833e-23, 2.238721e-23, 2.089296e-23,
    1.995262e-23, 1.905461e-23, 1.862087e-23, 1.862087e-23, 1.862087e-23,
    1.862087e-23, 1.905461e-23, 1.949845e-23, 1.995262e-23, 2.089296e-23,
    2.137962e-23, 2.238721e-23, 2.290868e-23, 2.398833e-23, 2.511886e-23,
    2.630268e-23, 2.754229e-23, 2.884032e-23, 2.951209e-23, 3.090295e-23,
    3.235937e-23, 3.388442e-23, 3.548134e-23, 3.715352e-23, 3.981072e-23,
    4.168694e-23,
])


def cooling_rate_sd93_cie(T):
    """Lambda(T) [erg cm^3/s] on the host (numpy): cubic spline in log-log
    with the reference's MinSlope = 8 cutoff below 10^4 K (:152) and the last
    segment's slope above the table."""
    lT = np.log10(np.asarray(T, dtype=float))
    lL = np.log10(_SD93_L)
    spl = TB.CubicSpline(_SD93_LOGT, lL)
    lo, hi = _SD93_LOGT[0], _SD93_LOGT[-1]
    slope_hi = (lL[-1] - lL[-2]) / (_SD93_LOGT[-1] - _SD93_LOGT[-2])
    mid = spl(np.clip(lT, lo, hi))
    out = np.where(lT < lo, lL[0] + 8.0 * (lT - lo), mid)
    out = np.where(lT > hi, lL[-1] + slope_hi * (lT - hi), out)
    return 10.0 ** out


def lambda_starbench(T: torch.Tensor) -> torch.Tensor:
    """StarBench analytic cooling function (reference: MPv8.cpp:90,360)."""
    return 2.0e-19 * torch.exp(-1.184e5 / (T + 1.0e3)) + \
        2.8e-28 * torch.sqrt(T) * torch.exp(-92.0 / T)


def cooling_rate_ki02(T):
    """Koyama & Inutsuka (2002) eq. 4 cooling on the host (numpy), with the
    Vazquez-Semadeni et al. (2007) typo corrections the reference applies
    (reference: cooling.cpp:379-397)."""
    return (2.0e-19 * np.exp(-1.184e5 / (T + 1.0e3))
            + 2.8e-28 * np.sqrt(T) * np.exp(-92.0 / T))


# curve names follow the reference enum (reference: mp_only_cooling.h /
# mp_only_cooling.cpp:383-411 Edot switch)
COOLING_CURVES = ("KI02", "SD93_CIE", "SD93_PLUS_HEATING",
                  "WSS09_CIE_ONLY_COOLING", "WSS09_CIE_PLUS_HEATING",
                  "WSS09_CIE_LINE_HEAT_COOL")


@dataclasses.dataclass(frozen=True)
class CoolingConfig:
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703
    min_temperature: float = 10.0
    max_temperature: float = 1.0e9
    mu: float = 0.61 * 1.0              # mean molecular weight (ionised)
    # which Edot function (reference cooling_flag; the reference recommends
    # WSS09_CIE_LINE_HEAT_COOL, mp_only_cooling.h:11-18)
    curve: str = "SD93_CIE"


class MPOnlyCooling(MicrophysicsBase):
    """Optically thin heating and cooling, no species tracking (reference:
    mp_only_cooling.cpp; fully ionised solar gas with Mu = 1.40 m_p, Mu_elec
    = 1.167 m_p, Mu_ion = 1.273 m_p, mp_only_cooling.cpp:81-87).

    Six selectable Edot functions (reference :383-411), combined at run time
    from number densities (never rho^2 ~ 1e-48, which leaves float32)."""

    name = "mp_only_cooling"
    dt_limit_processes = ("cooling",)  # reference: mp_only_cooling.cpp:333

    MU = 1.40 * M_P
    MU_ELEC = 1.167 * M_P
    MU_ION = 1.273 * M_P

    def __init__(self, mpc: CoolingConfig):
        if mpc.curve not in COOLING_CURVES:
            raise ValueError(f"unknown cooling curve {mpc.curve!r}")
        self.mpc = mpc
        # dense per-component lookups (reference: gen_mpoc_lookup_tables,
        # mp_only_cooling.cpp:525-560)
        Tg = np.logspace(np.log10(mpc.min_temperature),
                         np.log10(mpc.max_temperature), 300)
        tabs = {
            "sd93": cooling_rate_sd93_cie(Tg),
            "ki02": cooling_rate_ki02(Tg),
            "heat": 2.733e-21 * np.exp(-0.782991 * np.log(Tg)),
            "rrhp": TB.hii_rad_recomb_rate(Tg),
            "C_rrh": TB.hii_total_cooling(Tg),
            "C_ffhe": 6.72e-28 * np.sqrt(Tg),
            "C_fbdn": (1.20e-22 * np.exp(-33610.0 / Tg - (2180.0 / Tg) ** 2)
                       * np.exp(-Tg * Tg / 5.0e10)),
        }
        self.Tg = Tg
        self.tab = tabs
        # one stacked table: column 0 the grid temperature, then one column
        # a curve; the grid is log-uniform, so the bin index is arithmetic
        self._names = tuple(tabs)
        self._stack = np.stack([Tg] + [np.asarray(tabs[k])
                                       for k in self._names], axis=-1)
        self._lt0 = float(np.log10(Tg[0]))
        self._inv_dlt = float((len(Tg) - 1)
                              / (np.log10(Tg[-1]) - np.log10(Tg[0])))
        self._nt = len(Tg)
        self._kept: Dict = {}

    def _table(self, like: torch.Tensor) -> torch.Tensor:
        """The stacked table on ``like``'s device in its dtype, made once."""
        key = (like.dtype, like.device)
        if key not in self._kept:
            self._kept[key] = torch.as_tensor(self._stack).to(
                dtype=like.dtype, device=like.device)
        return self._kept[key]

    def _nT(self, P):
        mu_mass = self.mpc.mu * M_P
        n = P[RO] / mu_mass
        T = P[PG] / P[RO] * (mu_mass / K_B)
        return n, T

    def temperature(self, P, cfg: SimConfig):
        return self._nT(P)[1]

    def set_temp(self, P, T, cfg: SimConfig):
        n, _ = self._nT(P)
        return torch.cat([P[:PG], (n * K_B * T)[None], P[PG + 1:]])

    # -- the Edot menu (reference: mp_only_cooling.cpp:383-520) -------------
    def edot(self, rho: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """Net heating minus cooling rate [erg/cm^3/s] of the configured
        curve."""
        Tc = torch.clamp(T, self.mpc.min_temperature,
                         self.mpc.max_temperature)
        fi = (torch.log10(Tc) - self._lt0) * self._inv_dlt
        i = torch.clamp(fi.to(torch.int64), 0, self._nt - 2)
        stack = self._table(Tc)
        lo = stack[i]
        hi = stack[i + 1]
        w = ((Tc - lo[..., 0]) / (hi[..., 0] - lo[..., 0]))[..., None]
        vals = lo[..., 1:] + w * (hi[..., 1:] - lo[..., 1:])
        cols = {nm: vals[..., k] for k, nm in enumerate(self._names)}

        ne = rho / self.MU_ELEC
        ni = rho / self.MU_ION
        nmu = rho / self.MU
        cv = self.mpc.curve
        if cv == "KI02":
            return 2.0e-26 * nmu - nmu * nmu * cols["ki02"]
        if cv == "SD93_CIE":
            return -ne * ni * cols["sd93"]
        if cv == "SD93_PLUS_HEATING":
            return ne * nmu * cols["heat"] - ne * ni * cols["sd93"]
        if cv == "WSS09_CIE_ONLY_COOLING":
            # (reference :545-552: KI02-style 2e-26 n heating + CIE cooling)
            return 2.0e-26 * nmu - nmu * nmu * cols["sd93"]
        if cv == "WSS09_CIE_PLUS_HEATING":
            return ne * nmu * cols["heat"] - nmu * nmu * cols["sd93"]
        # WSS09_CIE_LINE_HEAT_COOL (recommended upstream): the stronger of
        # the Henney et al. (2009) forbidden-line and the CIE rates, plus H
        # recombination/bremsstrahlung cooling, He bremsstrahlung and 5 eV a
        # recombination of photoheating (reference :489-520)
        rate = torch.minimum(-cols["C_fbdn"] * ne * nmu,
                             -cols["sd93"] * nmu * nmu)
        rate = rate - cols["C_rrh"] * ne * nmu
        rate = rate - cols["C_ffhe"] * ne * nmu
        rate = rate + 8.01e-12 * cols["rrhp"] * ne * nmu
        return rate

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        """Eight substeps, semi-implicit: cooling damped implicitly, E' =
        E / (1 + h|Edot|/E), heating explicit; then the temperature floor
        and ceiling."""
        mpc = self.mpc
        n, _ = self._nT(P)
        E = P[PG] / (mpc.gamma - 1.0)
        h = dt / 8.0
        for _ in range(8):
            T = E * (mpc.gamma - 1.0) / (n * K_B)
            ed = self.edot(P[RO], T)
            E = torch.where(ed >= 0.0, E + h * ed, E / (1.0 - h * ed / E))
        E_floor = n * K_B * mpc.min_temperature / (mpc.gamma - 1.0)
        E_ceil = n * K_B * mpc.max_temperature / (mpc.gamma - 1.0)
        E = torch.minimum(torch.maximum(E, E_floor), E_ceil)
        return torch.cat([P[:PG], (E * (mpc.gamma - 1.0))[None],
                          P[PG + 1:]])

    def default_rt(self, P):
        return {}

    def _timescales_impl(self, P, cfg: SimConfig, rt: Dict):
        """Cooling time Eint / max(|Edot(T)|, |Edot(max(Tmin, T/2))|),
        skipped near the temperature floor (reference:
        mp_only_cooling.cpp:333-368, no extra safety factor); the least
        over the cells as a 0-d tensor."""
        mpc = self.mpc
        n, T = self._nT(P)
        E = P[PG] / (mpc.gamma - 1.0)
        ed = torch.maximum(
            torch.abs(self.edot(P[RO], T)),
            torch.abs(self.edot(P[RO], torch.clamp(
                0.5 * T, min=mpc.min_temperature))))
        t_cool = E / (ed + 1e-100)
        # 1e99 is inf in float32, as in the JAX package without x64
        big = 1.0e99 if t_cool.dtype == torch.float64 else float("inf")
        t_cool = torch.where(T >= 1.1 * mpc.min_temperature, t_cool, big)
        return torch.min(t_cool)
