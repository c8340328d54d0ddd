"""MPv3: non-equilibrium H photoionization + heating/cooling (the workhorse).

Counterpart of the reference module (reference:
source/microphysics/MPv3.cpp).  The model integrates two ODEs per cell — the
neutral fraction (1-x) and internal energy density E — with:

  - multifrequency or monochromatic photoionization + photoheating
    (Frank & Mellema 1994 discretized rates, MPv3.cpp:1713-1761)
  - Voronov (1997) collisional ionization + cooling
  - Hummer (1994) case-B recombination + recombination/free-free cooling
  - collisional-excitation cooling of H0 (Aggarwal 1983)
  - forbidden-line, Wiersma+ (2009) CIE, CII/OI, PAH metal cooling and
    Wolfire+ (2003) PAH heating, cosmic-ray heating/ionization,
    Henney+ (2009) UV/IR heating  (MPv3.cpp:1786-1890)

Where the reference hands each cell to CVODE (BDF + Newton, one serial
N_Vector per cell — cvode_integrator.h:106-131), this module integrates ALL
cells at once: cells whose relative change is below EULER_CUTOFF take a
forward-Euler step (MPv3.cpp:1170-1180), the rest take backward-Euler Newton
substeps.

Two integrators live side by side (see :meth:`MPv3._update_impl`):

- ``cfg.kernels == "auto"``: the fused update of :mod:`.fused_mpv3`, whose
  unit of adaptivity is a tile of 1024 consecutive cells (a CUDA kernel for a
  CUDA tensor, its plain version for a CPU tensor);
- ``cfg.kernels == "off"``: the ladder of this file, with ONE substep count
  and ONE Newton stopping criterion for the whole grid and the stiff cells
  compacted into a small buffer first.

The two differ by design in how many substeps a cell takes; each is held
tightly against its own counterpart in the JAX package, never against the
other.

Constants that leave float32: ``1e-300`` (Newton guards) and ``1e-100``
(timescale guard) become 0 in a float32 run, as they do in the JAX package
without x64; the formulas tolerate it (a zero denominator gives ``inf``, which
the ``min`` reductions discard).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import tracing
from ..config import SimConfig
from ..constants import K_B, M_P, PG, RO
from . import tables as TB
from .base import MicrophysicsBase

EULER_CUTOFF = 0.05     # reference: MPv3.h:90
MIN_NEUTRAL = 1.0e-20   # reference: MPv3.h:94 JM_MINNEU
DTFRAC = 0.25           # tier-2/6 fraction (reference: MPv3.cpp:188-224)
SIGMA0 = 6.3042e-18     # H0 photoionization cross-section at threshold
E_MONO = 2.98e-11       # 5 eV above threshold (reference: MPv3.cpp:1744)
E_EXCESS = 8.01e-12


def jacobian_columns(rhs, o, e):
    """``rhs(o, e)`` (a pair) and the two columns of its Jacobian, from one
    forward-mode pass over the state stacked twice, with the tangents
    d/do and d/de: ``(f0, f1, df0/do, df1/do, df0/de, df1/de)``, the values
    of ``torch.func.jvp`` with each tangent, bit for bit (every operation
    of ``rhs`` is elementwise), in half its launches and without its
    per-operation dispatch (the plain ladders' host cost, ROADMAP C12)."""
    one, zero = torch.ones_like(o), torch.zeros_like(o)
    with fwAD.dual_level():
        f = rhs(fwAD.make_dual(torch.stack([o, o]), torch.stack([one, zero])),
                fwAD.make_dual(torch.stack([e, e]), torch.stack([zero, one])))
        (p0, t0), (p1, t1) = (fwAD.unpack_dual(v) for v in f)
    return p0[0], p1[0], t0[0], t1[0], t0[1], t1[1]


def dtlimit_tier_params(tier: int):
    """(dtfrac, energy_limit, relative_neufrac) for an MPV3_DTLIMIT tier
    (reference: MPv3.cpp:185-228)."""
    fracs5 = (1.0, 0.5, 0.25, 0.125, 0.0625)
    fracs4 = (0.5, 0.25, 0.125, 0.0625)
    if 0 <= tier <= 4:
        return fracs5[tier], False, False
    if 5 <= tier <= 8:
        return fracs4[tier - 5], True, False
    if 9 <= tier <= 12:
        return fracs4[tier - 9], True, True
    raise ValueError(f"MPV3_DTLIMIT tier {tier} not in 0..12 "
                     "(reference: MPv3.cpp:185-228)")


@dataclasses.dataclass(frozen=True)
class MPv3Config:
    """Static chemistry configuration (reference: SimParams.EP + RS).

    ``dtlimit_tier`` defaults to 6 (DTFRAC = 0.25 on |xdot| plus the
    energy-change limit), as in the JAX package this port follows; PION
    itself compiles tier 2.  Set ``dtlimit_tier=2`` for PION's step sizes."""

    tracer_slot: int                  # index of x(H+) in the primitive vector
    gamma: float = 5.0 / 3.0
    helium_mass_frac: float = 0.2703  # reference EP default
    metal_mass_frac: float = 0.0142
    min_temperature: float = 10.0
    max_temperature: float = 1.0e9
    # ionizing source: None | "mono" | "mfion"
    ion_src: Optional[str] = None
    n_idot: float = 0.0               # ionizing photon rate [1/s]
    tstar: float = 0.0                # blackbody T for mfion
    rstar_cm: float = 0.0             # stellar radius [cm] for mfion
    n_diff_srcs: int = 0              # UV-heating source count
    n_table: int = 200                # lookup-table resolution
    #: MPV3_DTLIMIT tier (reference: MPv3.cpp:185-228 + defines/
    #: functionality_flags.h:63): 0-4 = DTFRAC {1,.5,.25,.125,.0625} on
    #: |xdot| only; 5-8 = + energy-change limit; 9-12 = + relative neutral
    #: fraction.  **The default is tier 6** (DTFRAC=0.25 with the energy
    #: limit), as in the JAX package this port follows; PION itself compiles
    #: tier 2.  A run that is to match PION's step sizes sets
    #: ``dtlimit_tier=2``.
    dtlimit_tier: int = 6

    @property
    def x_frac(self) -> float:
        return 1.0 - self.helium_mass_frac

    @property
    def mean_mass_per_h(self) -> float:
        return M_P / self.x_frac

    @property
    def n_ion(self) -> float:   # ions per H nucleon when ionised (JM_NION)
        return 1.0 + 0.25 * self.helium_mass_frac / self.x_frac

    @property
    def n_elec(self) -> float:  # electrons per ionised H (JM_NELEC)
        return 1.0 + 0.25 * self.helium_mass_frac / self.x_frac

    @property
    def metallicity(self) -> float:
        return self.metal_mass_frac / 0.0142


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``min(max(x, lo), hi)``.  Written with ``maximum``/``minimum`` so that
    its forward-mode derivative is 1/2 at a bound, as ``jnp.clip`` has it
    (``torch.clamp`` gives 1 there); the Newton Jacobian sees the difference
    for a cell that sits exactly on ``MIN_NEUTRAL``."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _bin_index(f: torch.Tensor, n: int) -> torch.Tensor:
    """Truncated, clipped bin index of a fractional table coordinate; carries
    no derivative."""
    return torch.clamp(f.detach().to(torch.int64), 0, n - 2)


class MPv3(MicrophysicsBase):
    """Vectorized MPv3 chemistry module."""

    name = "MPv3"

    def __init__(self, mpc: MPv3Config):
        self.mpc = mpc
        self._build_tables()
        self._tab_cache: Dict = {}

    # -- setup-time table construction (numpy; reference: MPv3.cpp:1945) ----
    def _build_tables(self):
        c = self.mpc
        NT = c.n_table
        Z = c.metallicity
        T = np.logspace(np.log10(c.min_temperature),
                        np.log10(c.max_temperature), NT)
        ne = np.logspace(-6.0, 6.0, NT)
        cir, cicr = TB.hi_coll_ion_rates(T)
        t = {
            "T": T, "ne": ne,
            "cirh": cir,                       # collisional ionization rate
            "C_cih0": cicr,                    # its cooling
            "rrhp": TB.hii_rad_recomb_rate(T),
            "C_rrh": TB.hii_total_cooling(T),
            "C_ffhe": 1.68e-27 * (c.n_ion - 1.0) * np.sqrt(T),
            "C_cxh0": TB.hi_coll_excitation_cooling_rate(T)
                      * np.exp(-T * T / 5.0e10),
            "C_fbdn": 1.20e-22 * Z
                      * np.exp(-33610.0 / T - (2180.0 / T) ** 2)
                      * np.exp(-T * T / 5.0e10),
            "C_cie": Z * TB.cooling_rate_wss09_metals(T),
            "C_cxch": 3.15e-27 * Z * np.exp(-92.0 / T),
            "C_cxo": 3.96e-28 * Z * np.exp(0.4 * np.log(T) - 228.0 / T),
        }
        TT, NE = np.meshgrid(T, ne, indexing="ij")
        t["H_pah"] = 1.083e-25 * Z / (1.0 + 9.77e-3 * (np.sqrt(TT) / NE) ** 0.73)
        t["C_pah"] = 3.02e-30 * Z * np.exp(
            0.94 * np.log(TT)
            + 0.74 * TT ** (-0.068) * np.log(3.4 * np.sqrt(TT) / NE)
        ) * NE
        t["C_cxce"] = (1.4e-23 * Z * np.exp(-0.5 * np.log(TT) - 92.0 / TT)
                       * NE / (1.0 + 0.05 * NE * (TT / 2000.0) ** (-0.37)))
        if c.ion_src == "mfion":
            pt = TB.build_photoion_tables(c.tstar, c.rstar_cm)
            # normalize the (log10) rate tables by their peak so runtime
            # exponentials stay in float32 range (raw rates ~1e47 overflow
            # f32); the peak is restored through rt["sv"] = 10^ls / Vshell,
            # a host-side f64 product that is itself f32-representable
            self.rate_scale_log = float(np.max(pt["pi_rate"]))
            for nm in ("pi_rate", "pi_heat", "lt_pi_rate", "lt_pi_heat"):
                pt[nm] = pt[nm] - self.rate_scale_log
            t.update(pt)
            # stacked (NTAU, 4) photoion table: one row gather serves all
            # four curves
            t["tau_stack"] = np.stack(
                [t["pi_rate"], t["pi_heat"],
                 t["lt_pi_rate"], t["lt_pi_heat"]], axis=-1)
            # the same curve by curve, (4, NTAU): the CUDA kernels' layout
            t["tau_rows"] = np.ascontiguousarray(t["tau_stack"].T)
            lg = t["log_tau"]
            self._ltau0 = float(lg[0])
            self._inv_dltau = float((len(lg) - 1) / (lg[-1] - lg[0]))
            self._n_tau = len(lg)
        else:
            self.rate_scale_log = 0.0
        # -- stacked hot-loop tables -------------------------------------
        # All grids are log-uniform, so the bin index is arithmetic (no
        # binary search) and every 1D curve comes from ONE pair of row
        # gathers on a (NT, 1+K) stack whose column 0 is the T grid itself
        # (for exact linear-in-T interpolation identical to the reference's
        # table scheme, MPv3.cpp:1655-1676).
        self._t1_names = ("cirh", "C_cih0", "rrhp", "C_rrh", "C_ffhe",
                          "C_cxh0", "C_fbdn", "C_cie", "C_cxch", "C_cxo")
        t["t1_stack"] = np.stack([T] + [t[k] for k in self._t1_names],
                                 axis=-1)
        # (11, NT), the T grid then the curves: the CUDA kernels' layout
        t["t1_rows"] = np.ascontiguousarray(t["t1_stack"].T)
        self._lt0 = float(np.log10(T[0]))
        self._inv_dlt = float((NT - 1) / (np.log10(T[-1]) - np.log10(T[0])))
        #: the rate tables, float64 numpy arrays by name
        self.tab = {k: v for k, v in t.items() if isinstance(v, np.ndarray)}
        self.tau_bounds = (1.0e-3, 1.0e6)

    def table(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """One of :attr:`tab` as a tensor of ``like``'s dtype on its device
        (made once per dtype and device)."""
        key = (name, like.dtype, like.device)
        if key not in self._tab_cache:
            self._tab_cache[key] = torch.as_tensor(
                self.tab[name], dtype=like.dtype,
                device=like.device).contiguous()
        return self._tab_cache[key]

    # -- thermodynamics ----------------------------------------------------
    def n_H(self, rho):
        return rho / self.mpc.mean_mass_per_h

    def n_tot(self, nH, x):
        return (self.mpc.n_ion + self.mpc.n_elec * x) * nH

    def temperature_of(self, nH, Eint, x):
        return (self.mpc.gamma - 1.0) * Eint / (K_B * self.n_tot(nH, x))

    def temperature(self, P, cfg: SimConfig):
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        return self.temperature_of(nH, P[PG] / (self.mpc.gamma - 1.0), x)

    def set_temp(self, P, T, cfg: SimConfig):
        """Reset pressure so temperature is T (reference: MPv3.cpp:1053).
        Returns a new tensor."""
        nH = self.n_H(P[RO])
        x = P[self.mpc.tracer_slot]
        out = P.clone()
        out[PG] = self.n_tot(nH, x) * K_B * T
        return out

    # -- fused table lookups (hot loop; see _build_tables) -----------------
    def _t1_lookup(self, Tc):
        """All 1D temperature curves from one pair of row gathers: the bin
        index from ``log10(Tc)``, the weight from the stored grid.  Returns a
        dict of curve values."""
        stack = self.table("t1_stack", Tc)
        nt = self.mpc.n_table
        f = (torch.log10(Tc) - self._lt0) * self._inv_dlt
        i = _bin_index(f, nt)
        lo = stack[i]          # (..., 1+K)
        hi = stack[i + 1]
        Tgi = lo[..., 0]
        Tgi1 = hi[..., 0]
        w = ((Tc - Tgi) / (Tgi1 - Tgi))[..., None]
        vals = lo[..., 1:] + w * (hi[..., 1:] - lo[..., 1:])
        return {nm: vals[..., k] for k, nm in enumerate(self._t1_names)}

    def _t2_eval(self, Tc, ne):
        """The 2D (T, ne) heating/cooling terms evaluated directly from the
        Wolfire+ (2003) closed forms the reference tabulates
        (reference builds 2D lookup tables from these same expressions and
        plane-interpolates at runtime, MPv3.cpp:1817; direct evaluation is
        the same physics minus the interpolation error)."""
        Z = self.mpc.metallicity
        lnT = torch.log(Tc)
        sqT = torch.sqrt(Tc)
        H_pah = 1.083e-25 * Z / (1.0 + 9.77e-3 * (sqT / ne) ** 0.73)
        C_pah = 3.02e-30 * Z * torch.exp(
            0.94 * lnT + 0.74 * Tc ** (-0.068) * torch.log(3.4 * sqT / ne)
        ) * ne
        C_cxce = (1.4e-23 * Z * torch.exp(-0.5 * lnT - 92.0 / Tc)
                  * ne / (1.0 + 0.05 * ne * (Tc / 2000.0) ** (-0.37)))
        return {"H_pah": H_pah, "C_pah": C_pah, "C_cxce": C_cxce}

    def tau_rows(self, tau, stack):
        """Photoion rate, heat and their low-tau slopes at ``tau``: row
        gathers on a (NTAU, 4) stack, linear in ``log10 tau``; ``(..., 4)``."""
        tmin, tmax = self.tau_bounds
        lt = torch.log10(clip(tau, tmin, tmax))
        f = (lt - self._ltau0) * self._inv_dltau
        i = _bin_index(f, self._n_tau)
        w = (f - i.to(f.dtype))[..., None]
        lo = stack[i]
        hi = stack[i + 1]
        v = lo + clip(w, 0.0, 1.0) * (hi - lo)
        return torch.exp(TB.LOGTEN * v)

    def _tau_lookup(self, tau0, dtau_cur, stack=None):
        """Rows at tau0 and at tau0+dtau.  ``stack`` overrides the setup-time
        table: evolving sources pass the current star's table through the rt
        dict (reference: set_multifreq_source_properties re-integrates the
        rate tables on >1% changes, MPv3.cpp:686)."""
        if stack is None:
            stack = self.table("tau_stack", tau0)
        return self.tau_rows(tau0, stack), self.tau_rows(tau0 + dtau_cur,
                                                         stack)

    def set_multifreq_source_properties(self, tstar: float, rstar_cm: float):
        """Re-integrate the multifrequency photoionization tables for new
        stellar properties (reference: MPv3::set_multifreq_source_properties,
        MPv3.cpp:686; called by update_RT_source_properties when an
        evolving source moves >1% in L or T).  Returns the peak-normalized
        (NTAU, 4) stack as a float64 numpy array and its log10 peak —
        callers feed the stack through rt['tau_stack'] and fold
        10^(ls_new - ls_setup) into the source's relative-strength scale."""
        pt = TB.build_photoion_tables(tstar, rstar_cm)
        ls = float(np.max(pt["pi_rate"]))
        stack = np.stack([pt["pi_rate"] - ls, pt["pi_heat"] - ls,
                          pt["lt_pi_rate"] - ls, pt["lt_pi_heat"] - ls],
                         axis=-1)
        return stack, ls

    # -- the ODE right-hand side (reference: MPv3.cpp:1619-1936) -----------
    def ydot(self, one_minus_x, Eint, nH, rt: Dict):
        c = self.mpc
        omx = torch.maximum(one_minus_x, one_minus_x.new_tensor(MIN_NEUTRAL))
        x = 1.0 - omx
        T = self.temperature_of(nH, Eint, x)
        Tc = clip(T, c.min_temperature, c.max_temperature)
        expnh = torch.exp(-nH / 1.0e4)
        ne = c.n_elec * x * nH + nH * 1.5e-4 * c.metallicity * expnh

        t1 = self._t1_lookup(Tc)
        t2 = self._t2_eval(Tc, ne)

        # collisional ionization + cooling
        omx_dot = -(t1["cirh"] * ne * omx)
        Edot = -(t1["C_cih0"] * ne * omx)

        # photoionization — summed over ionizing sources (per-source column
        # sets in rt["ion"]; reference: calc_microphysics_dU loops
        # FVI_ionising_srcs, rad_src_data.h per-source Tau slots).  A plain
        # rt dict without "ion" is treated as one source (default_rt, and
        # direct mp.update(..., rt=...) callers).
        if c.ion_src is not None:
            entries = rt.get("ion")
            if entries is None:
                entries = (rt,)
            for e in entries:
                dtau_cur = nH * e["ds"] * omx * SIGMA0
                tau0 = e["tau0"]
                if c.ion_src == "mono":
                    frac = float(TB.hi_xsection_fractional(E_MONO))
                    dtau = dtau_cur * frac
                    # nv = Ndot/Vshell, precomputed on the host at f64 so
                    # neither factor is materialized at f32 (both
                    # overflow; the ratio doesn't)
                    nv = e.get("nv", None)
                    if nv is None:
                        nv = e["n_idot"] / e["vshell"]
                    rate = nv * torch.exp(-tau0 * frac)
                    rate = rate * torch.where(
                        dtau < 1.0e-4, dtau, 1.0 - torch.exp(-dtau)) / nH
                    omx_dot = omx_dot - rate
                    Edot = Edot + rate * E_EXCESS
                else:  # mfion (reference: Hi_discrete_multifreq_*:101-155)
                    # tables are peak-normalized (see _build_tables); sv
                    # restores the scale divided by Vshell, f32-safe
                    sv = e.get("sv", None)
                    if sv is None:
                        sv = float(np.exp(TB.LOGTEN * self.rate_scale_log)) \
                            / e["vshell"]
                    r0, r1 = self._tau_lookup(tau0, dtau_cur,
                                              stack=e.get("tau_stack"))
                    big = r0[..., 0] - r1[..., 0]
                    small = r0[..., 2] * dtau_cur / (SIGMA0 * nH)
                    pir = torch.where(dtau_cur < 0.01, small, big) * sv / nH
                    bigh = r0[..., 1] - r1[..., 1]
                    smallh = r0[..., 3] * dtau_cur / (SIGMA0 * nH)
                    pih = torch.where(dtau_cur < 0.01, smallh, bigh) * sv / nH
                    omx_dot = omx_dot - pir
                    Edot = Edot + pih

        # recombination + cooling
        omx_dot = omx_dot + t1["rrhp"] * x * ne
        Edot = Edot - t1["C_rrh"] * x * ne
        # He free-free
        Edot = Edot - t1["C_ffhe"] * x * ne
        # H0 collisional excitation cooling
        Edot = Edot - t1["C_cxh0"] * omx * ne

        # UV/IR heating (Henney+09; reference: MPv3.cpp:1786-1805)
        if c.n_diff_srcs:
            g0uv = rt["g0_uv"]
            g0ir = rt["g0_ir"]
            Edot = Edot + 1.9e-26 * c.metallicity * g0uv / (
                1.0 + 6.4 * (g0uv / nH))
            Edot = Edot + 7.7e-32 * c.metallicity * g0ir / (
                1.0 + 3.0e4 / nH) ** 2

        # cosmic-ray heating and ionization (Wolfire+03)
        Edot = Edot + 5.0e-28 * omx
        omx_dot = omx_dot - 1.8e-17 * omx

        # PAH heating (2D table)
        Edot = Edot + omx * t2["H_pah"]

        # metal cooling: max(forbidden-line, CIE + CII-e)
        fbdn = t1["C_fbdn"] * x * ne
        cie = t1["C_cie"] * x * x * nH
        cie = cie + t2["C_cxce"]
        Edot = Edot - torch.maximum(fbdn, cie)

        # CII/OI cooling by neutral H collisions (Wolfire+03 eq C1/C3)
        Edot = Edot - t1["C_cxch"] * nH * omx * expnh
        Edot = Edot - t1["C_cxo"] * nH * omx

        # PAH cooling
        Edot = Edot - t2["C_pah"]

        Edot = Edot * nH
        # limit cooling near the temperature floor (reference: :1888-1890)
        Tmin = c.min_temperature
        cold = (Edot < 0.0) & (T < 2.0 * Tmin)
        Edot = torch.where(
            cold, torch.minimum(torch.zeros_like(Edot),
                                Edot * (T - Tmin) / Tmin), Edot)
        return omx_dot, Edot

    # -- integration (reference: MPv3.cpp:1146-1235 + cvode_integrator) ----
    def _stiff_solve(self, bufs, dt, n_sub=32, n_newton=8, stiffness=None,
                     mesh=None):
        """Backward-Euler ladder with vectorized, bound-limited 2x2 Newton
        solves on ``bufs``: the cells to step, ``(1-x, E, nH, rt)`` a
        device, stepped as one set; returns ``(1-x, E)`` a buffer.

        The Newton update is clipped per iteration (|dE| <= 0.6 E,
        |d(1-x)| <= 0.3): the energy equation is non-smooth at the Tmin
        cooling limiter and an unclipped Newton can oscillate across it;
        the clip makes the iteration monotone while staying quadratic near
        the root (the reference leans on CVODE's internal step control for
        the same robustness — cvode_integrator.cpp).

        ``stiffness`` (optional 0-d tensor: the global max |ydot*dt/y|)
        makes the ladder adaptive: the substep count scales with the
        stiffness (every cell shares the count) and each substep's Newton
        iteration stops on convergence, the largest correction over every
        buffer's cells.  The stopping test is read back to the host every
        iteration.  ``mesh``: a mesh of several processes whose ladders
        step together (``stiffness`` already reduced over them): the test
        is a max over the processes, which may hold no buffer."""
        if stiffness is not None:
            n_eff = int(torch.clamp(torch.ceil(4.0 * stiffness), 2, n_sub))
        else:
            n_eff = n_sub
        dev0 = bufs[0][0].device if bufs else stiffness.device
        dtype = bufs[0][1].dtype if bufs else stiffness.dtype

        def newton_step(rhs, h, y, y_prev):
            omx, E = y
            # the exact per-cell 2x2 Jacobian by forward-mode
            # differentiation of ydot, both columns in one pass
            f0, f1v, j00, j10, j01, j11 = jacobian_columns(rhs, omx, E)
            # g(y) = y - y_prev - h*f(y);  J_g = I - h*J_f
            g0 = omx - y_prev[0] - h * f0
            g1 = E - y_prev[1] - h * f1v
            a = 1.0 - h * j00
            b = -h * j01
            cc = -h * j10
            d = 1.0 - h * j11
            det = a * d - b * cc
            det = torch.where(torch.abs(det) > 1e-300, det,
                              torch.ones_like(det))
            d_omx = (d * g0 - b * g1) / det
            d_E = (a * g1 - cc * g0) / det
            d_omx = torch.clamp(d_omx, -0.3, 0.3)
            d_E = torch.minimum(torch.maximum(d_E, -0.6 * E), 0.6 * E)
            omx_n = torch.clamp(omx - d_omx, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
            E_n = torch.maximum(E - d_E, 1.0e-10 * y_prev[1])
            return (omx_n, E_n)

        steps = []
        for omx, E, nH, rt in bufs:
            def rhs(o, e, nH=nH, rt=rt):
                return self.ydot(o, e, nH, rt)
            h = torch.as_tensor(dt, dtype=E.dtype, device=E.device) / n_eff
            steps.append((rhs, h))

        # convergence tolerance tracks the working precision: 1e-11 is
        # below f32 resolution and would force every Newton loop to the
        # n_newton cap
        tol = 1.0e-11 if dtype == torch.float64 else 1.0e-6

        def newton_converged(ys):
            """Newton to convergence (or n_newton), global max criterion."""
            ys_prev = ys
            i, err = 0, float("inf")
            while i < n_newton and err > tol:
                ys_n = [newton_step(rhs, h, y, yp) for (rhs, h), y, yp
                        in zip(steps, ys, ys_prev)]
                errs = [torch.maximum(
                    torch.max(torch.abs(yn[0] - y[0])),
                    torch.max(torch.abs((yn[1] - y[1])
                                        / torch.clamp(y[1], min=1e-300))))
                    .to(dev0) for yn, y in zip(ys_n, ys)]
                err = (torch.max(torch.stack(errs)) if errs else
                       torch.full((), -float("inf"), dtype=dtype,
                                  device=dev0))
                if mesh is not None:
                    err = mesh.reduce(err, "max")
                err = float(err)
                ys = ys_n
                i += 1
            return ys

        ys = [(omx, E) for omx, E, _, _ in bufs]
        for _ in range(n_eff):
            ys = newton_converged(ys)
        return ys

    def local_state(self, P):
        """``(1-x, E, nH)`` of a primitive state as the integrator sees it:
        the neutral fraction clipped into ``[MIN_NEUTRAL, 1-MIN_NEUTRAL]``
        and a negative or zero pressure floored at Tmin (reference:
        MPv3.cpp:985-995)."""
        c = self.mpc
        nH = self.n_H(P[RO])
        Eint = P[PG] / (c.gamma - 1.0)
        omx = torch.clamp(1.0 - P[c.tracer_slot], MIN_NEUTRAL,
                          1.0 - MIN_NEUTRAL)
        E_floor = self.n_tot(nH, 1.0 - omx) * K_B * c.min_temperature \
            / (c.gamma - 1.0)
        return omx, torch.where(Eint > 0.0, Eint, E_floor), nH

    @staticmethod
    def _euler_part(omx, Eint, dt, first):
        """The forward-Euler step, which cells take it (|ydot dt / y| below
        EULER_CUTOFF) and the stiffness: that ratio's max over the others
        (0 where there is none)."""
        d_omx, d_E = first
        maxdelta = torch.maximum(torch.abs(d_omx * dt / omx),
                                 torch.abs(d_E * dt / Eint))
        use_euler = maxdelta < EULER_CUTOFF
        stiffness = torch.max(torch.where(use_euler,
                                          torch.zeros_like(maxdelta),
                                          maxdelta))
        return omx + dt * d_omx, Eint + dt * d_E, use_euler, stiffness

    @staticmethod
    def _ladder_sets(use_eulers, mesh=None):
        """The cells the plain ladder steps, a block each (the blocks of a
        grid in C order, so the last holds the grid's last cell; one block:
        the grid; None at the blocks of other processes of ``mesh``, over
        whose processes the counts are summed): None when no cell is past
        the Euler cutoff, else
        ``(idx, gidx)`` a block.  Stiff-cell compaction: the stiff cells are
        typically a thin shell (the ionization front), a few % of the grid,
        so they are gathered into a buffer (``idx``, flat) and the Newton
        ladder runs on the small array; every cell (``idx`` and ``gidx``
        None: the dense ladder) when the grid is small or its stiff set
        overflows the buffer's capacity, both the whole grid's.  ``gidx``:
        the buffer's cells, with one copy of the grid's last cell while the
        buffer has room (the JAX package pads its fixed-capacity buffer
        with copies of that cell, whose Newton error enters the stopping
        test; the copies are identical, and one reproduces that).  The copy
        is dropped at the scatter."""
        ncell = sum(u.numel() for u in use_eulers if u is not None)
        idxs = [None if u is None
                else torch.nonzero((~u).reshape(-1)).reshape(-1)
                for u in use_eulers]
        n_stiff = sum(i.numel() for i in idxs if i is not None)
        if mesh is not None:
            ncell, n_stiff = mesh.reduce_ints([ncell, n_stiff], "sum")
        cap = min(ncell, max(4096, ncell // 8))
        if n_stiff == 0:
            return None
        if cap >= ncell or n_stiff > cap:
            return [(None, None)] * len(idxs)
        sets = [(i, i) for i in idxs]
        if n_stiff < cap and idxs[-1] is not None:
            last = idxs[-1]
            sets[-1] = (last, torch.cat([
                last, last.new_tensor([use_eulers[-1].numel() - 1])]))
        return sets

    @staticmethod
    def _take(trees, gidxs, grid_shape):
        """Each tree (a cell array, or an rt dict that may nest per-source
        dicts under "ion") at its flat cells ``gidx`` (all cells when None),
        the trees' cells joined end to end; what is not a cell array (a
        table, a number) is the first tree's."""
        v = trees[0]
        if isinstance(v, dict):
            return {k: MPv3._take([t[k] for t in trees], gidxs, grid_shape)
                    for k in v}
        if isinstance(v, (tuple, list)):
            return tuple(MPv3._take([t[j] for t in trees], gidxs, grid_shape)
                         for j in range(len(v)))
        if isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(grid_shape):
            parts = [t.reshape(-1) if g is None else t.reshape(-1)[g]
                     for t, g in zip(trees, gidxs)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        return v

    @staticmethod
    def _put(a, vals, idx):
        """``a`` with the ladder's values at its stiff cells (``vals`` may
        run past them: the padding copy)."""
        if idx is None:
            return vals.reshape(a.shape)
        out = a.reshape(-1).clone()
        out[idx] = vals[:idx.numel()]
        return out.reshape(a.shape)

    def _update_impl(self, P, dt, cfg: SimConfig, rt: Dict):
        """TimeUpdateMP(_RTnew): advance chemistry+energy of every cell by dt
        and return the updated primitive tensor (``P`` is not written)."""
        if not self._use_fused(cfg):
            return self.update_blocks([P], [dt], cfg, [rt])[0]
        from . import fused_mpv3

        dt = torch.as_tensor(dt, dtype=P.dtype, device=P.device)
        omx, Eint, nH = self.local_state(P)
        # the ladder's counters, with tracing on (None off)
        omx1, E1 = fused_mpv3.update(self, omx, Eint, nH, dt, rt,
                                     f0=rt.get("f0"),
                                     stats=tracing.ladder_stats(omx.device))
        return self._finish_update(P, nH, omx1, E1)

    def update_blocks(self, Ps, dts, cfg: SimConfig, rts, mesh=None):
        """The plain ladder's update (``kernels="off"``) of the blocks of a
        grid (``Ps``, ``dts`` and ``rts`` a block each, in the mesh's C
        order; one block: the grid).  The blocks step as the whole grid
        does on one device, so each cell's result is the one-device run's:
        the stiffness is the max over them (the JAX package's whole-grid
        max, ``mpv3.py:600``), the compaction's choice and capacity are the
        whole grid's (:meth:`_ladder_sets`), and one Newton stopping test
        reads every block's ladder cells.  The blocks of a device share
        one buffer, so a mesh costs the host one ladder a device.  On a
        ``mesh`` of several processes ``Ps`` holds None at the other
        processes' blocks (and so does the result): the counts, the
        stiffness and the stopping test are reduced over the processes, and
        the copy of the grid's last cell goes to the last shard's owner."""
        mesh = mesh if mesh is not None and mesh.distributed else None
        own = [i for i, P in enumerate(Ps) if P is not None]
        parts = [None] * len(Ps)
        for i in own:
            P, rt = Ps[i], rts[i]
            dt = torch.as_tensor(dts[i], dtype=P.dtype, device=P.device)
            omx, Eint, nH = self.local_state(P)
            first = self.ydot(omx, Eint, nH, rt)
            # global short-circuit: when NO cell is past the Euler cutoff
            # the implicit ladder is skipped entirely (reference: the
            # per-cell Euler-vs-CVODE branch, MPv3.cpp:1146-1235
            # EULER_CUTOFF)
            parts[i] = (omx, Eint, nH) + self._euler_part(
                omx, Eint, dt, first)
        st = [None if p is None else (p[0], p[1]) for p in parts]
        sets = self._ladder_sets([None if p is None else p[5]
                                  for p in parts], mesh)
        if sets is not None:
            dev0 = Ps[own[0]].device
            stiffness = torch.max(torch.stack([parts[i][6].to(dev0)
                                               for i in own]))
            if mesh is not None:
                stiffness = mesh.reduce(stiffness, "max")
            groups, bufs = [], []
            for dev in dict.fromkeys(Ps[i].device for i in own):
                members = [i for i in own if Ps[i].device == dev
                           and (sets[i][1] is None or sets[i][1].numel())]
                if not members:
                    continue
                gidxs = [sets[i][1] for i in members]
                shape = parts[members[0]][0].shape
                groups.append(members)
                bufs.append(tuple(
                    self._take([parts[i][k] for i in members], gidxs, shape)
                    for k in (0, 1, 2))
                    + (self._take([rts[i] for i in members], gidxs, shape),))
            outs = self._stiff_solve(bufs, dts[own[0]], stiffness=stiffness,
                                     mesh=mesh)
            for members, (o1, e1) in zip(groups, outs):
                sizes = [parts[i][0].numel() if sets[i][1] is None
                         else sets[i][1].numel() for i in members]
                for i, o, e in zip(members, o1.split(sizes),
                                   e1.split(sizes)):
                    idx = sets[i][0]
                    st[i] = (self._put(parts[i][0], o, idx),
                             self._put(parts[i][1], e, idx))
        out = [None] * len(Ps)
        for i in own:
            omx, Eint, nH, omx_eul, E_eul, use_euler, _ = parts[i]
            omx_st, E_st = st[i]
            out[i] = self._finish_update(
                Ps[i], nH, torch.where(use_euler, omx_eul, omx_st),
                torch.where(use_euler, E_eul, E_st))
        return out

    def _use_fused(self, cfg: SimConfig) -> bool:
        """Gate for the fused update/ydot of :mod:`.fused_mpv3`:
        ``cfg.kernels`` is not "off" and the module uses MPv3's own rate
        assembly — a subclass that overrides ``ydot`` with different physics
        must NOT take a kernel built from MPv3's formulas.  Nothing else
        leads round the kernels: for a CUDA tensor outside
        ``fused_mpv3.supports`` the wrappers raise."""
        return cfg.kernels != "off" and type(self).ydot is MPv3.ydot

    def _finish_update(self, P, nH, omx1, E1):
        """Shared post-integration clamps + primitive assembly
        (reference: convert_local2prim, MPv3.cpp:1000-1014)."""
        c = self.mpc
        omx1 = torch.clamp(omx1, MIN_NEUTRAL, 1.0 - MIN_NEUTRAL)
        x1 = 1.0 - omx1
        # temperature clamps (reference: convert_local2prim:1000-1014)
        T1 = self.temperature_of(nH, E1, x1)
        ntot = self.n_tot(nH, x1)
        E1 = torch.where(T1 > 1.01 * c.max_temperature,
                         ntot * K_B * c.max_temperature / (c.gamma - 1.0), E1)
        E1 = torch.where(T1 < 0.99 * c.min_temperature,
                         ntot * K_B * c.min_temperature / (c.gamma - 1.0), E1)
        out = P.clone()
        out[PG] = E1 * (c.gamma - 1.0)
        out[c.tracer_slot] = x1
        return out

    def _timescales_impl(self, P, cfg: SimConfig, rt: Dict,
                         with_ydot: bool = False):
        """Chemistry timestep limit (reference: MPv3.cpp:1268-1345,
        MP_LIM3-style: DTFRAC / |d(1-x)/dt| plus energy-change limit), a
        0-d tensor.  ``with_ydot``: also return the (d_omx, d_E) evaluation
        so the caller can seed the subsequent update's first evaluation."""
        c = self.mpc
        # the same local state as the update, so the returned ydot can be
        # reused verbatim as the update's first evaluation
        omx, Eint, nH = self.local_state(P)
        if self._use_fused(cfg):
            from . import fused_mpv3

            d_omx, d_E = fused_mpv3.ydot(self, omx, Eint, nH, rt)
        else:
            d_omx, d_E = self.ydot(omx, Eint, nH, rt)
        frac, use_e, use_relx = dtlimit_tier_params(
            getattr(c, "dtlimit_tier", 6))
        num = torch.clamp(omx, min=5.0e-2) if use_relx else 1.0
        # 1e-100 is 0 in float32: a cell at rest then gives inf, which the
        # min discards
        t = frac * num / (torch.abs(d_omx) + 1.0e-100)
        if use_e:
            t = torch.minimum(t, frac * Eint / (torch.abs(d_E) + 1.0e-100))
        tmin = torch.min(t)
        if with_ydot:
            return tmin, (d_omx, d_E)
        return tmin

    def default_rt(self, P) -> Dict:
        """No-raytracer defaults (reference: MPv3 constructor :338-346)."""
        z = torch.zeros_like(P[RO])
        return {
            "tau0": z + 1.0e6, "ds": z, "vshell": z + 1.0e30,
            "n_idot": self.mpc.n_idot, "nv": z, "sv": z,
            "g0_uv": z, "g0_ir": z,
        }
