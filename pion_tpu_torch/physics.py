"""Coupled physics set: chemistry module + radiation sources.

Binds a microphysics module and a raytracer into the objects the time
integrator consumes (the equivalent of the reference's MP/RT global pointers
plus setup_raytracing / RT_all_sources orchestration —
reference: source/sim_control/sim_init.cpp:254-256,806;
time_integrator.cpp:253-470 calc_microphysics_dU).

Stellar winds are internal boundaries (:mod:`.winds`): ``setup`` carves one
region per wind source, and the stepper overwrites them after every partial
update.

Constants that leave float32: the no-source defaults ``vshell = 1e200`` is
``inf`` there, as in the JAX package without x64; nothing reads it but
callers that divide by it.  ``Ndot`` (~1e48 /s) and the shell volumes
(~1e51 cm^3) each leave float32 too, so their ratio is taken on the host at
float64 and only the ratio is cast.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import SimConfig
from .constants import RO, Coord
from .grid import Geometry
from .microphysics.mpv3 import MIN_NEUTRAL, SIGMA0
from .ops.eqns import prim_to_cons
from .raytracing import Raytracer, Source


@dataclasses.dataclass
class Physics:
    """Chemistry + radiation + internal wind boundaries."""

    mp: object = None                 # microphysics module (MPv3)
    sources: List[Source] = dataclasses.field(default_factory=list)
    raytracer: Optional[Raytracer] = None
    # EP.MP_timestep_limit mode (reference: sim_params.h:56-63): 0 = off
    # (dynamical dt only), 1 = cooling, 2 = cooling+recomb, 3 = +ionisation,
    # 4 = recomb only.  MPv3-family timescales serve every nonzero mode
    # (the reference ignores the per-process flags there, MPv3.cpp:1237).
    # Booleans coerce: True -> 1, False -> 0.
    dt_limit: int = 2
    wind_sources: List = dataclasses.field(default_factory=list)
    winds: List = dataclasses.field(default_factory=list)

    def setup(self, cfg: SimConfig, geom: Geometry):
        # N ionizing sources are supported with per-source column sets
        # (reference: rad_src_data.h:27-76 per-source Tau slots), as long
        # as they share one rate model (all mono or all mfion)
        effects = {s.effect for s in self.sources
                   if s.effect in ("mono", "mfion")}
        if len(effects) > 1:
            raise NotImplementedError(
                "mixed mono+mfion ionizing sources in one run are not "
                "supported (the chemistry module has one rate model)")
        # per-source mfion tables for sources with their own (Tstar, Rstar)
        # (reference: set_multifreq_source_properties is per source,
        # MPv3.cpp:431)
        self._src_static = {}
        if self.mp is not None and effects == {"mfion"}:
            for i, s in enumerate(self.sources):
                if s.effect == "mfion" and s.tstar > 0.0:
                    mpc = self.mp.mpc
                    if (abs(s.tstar - mpc.tstar) > 1e-6 * s.tstar
                            or abs(s.rstar_cm - mpc.rstar_cm)
                            > 1e-6 * max(s.rstar_cm, 1.0)):
                        stack, ls = self.mp.set_multifreq_source_properties(
                            s.tstar, s.rstar_cm)
                        self._src_static[i] = {"stack": stack, "ls": ls}
        if self.sources and self.raytracer is None:
            self.raytracer = Raytracer(cfg, geom, self.sources)
        if self.wind_sources and not self.winds:
            from .winds import make_wind_bcs

            self.winds = make_wind_bcs(cfg, geom, self.wind_sources)
        self._rate_cache: Dict = {}
        self._excl_cache: Dict = {}
        return self

    def apply_internal_bcs(self, P, t):
        """Overwrite wind regions (reference: TimeUpdateInternalBCs ->
        BC_update_STWIND, boundaries/stellar_wind_boundaries.cpp).  Returns
        a new tensor when there is a wind, ``P`` itself otherwise."""
        for w in self.winds:
            P = w.apply(P, t)
        return P

    # -- opacity (reference: MPv3::get_dtau, MPv3.cpp:1082-1112) -----------
    def dtau_for(self, src: Source, Ph, ds):
        mpc = self.mp.mpc
        rho = Ph[RO]
        if src.effect in ("mono", "mfion"):
            omx = torch.clamp(1.0 - Ph[mpc.tracer_slot], MIN_NEUTRAL,
                              1.0 - MIN_NEUTRAL)
            return rho * omx / mpc.mean_mass_per_h * SIGMA0 * ds
        if src.effect == "uv_heating":
            Z = getattr(mpc, "metallicity", 1.0)
            return rho * 5.348e-22 * Z / mpc.mean_mass_per_h * ds
        raise ValueError(f"unknown source effect {src.effect}")

    def for_level(self, cfg: SimConfig, geom: Geometry) -> "Physics":
        """Clone bound to one nested-grid level: same chemistry module and
        source list, per-level tracer geometry and wind masks (reference:
        setup_raytracing is called per level, sim_control_NG.cpp:138)."""
        return Physics(mp=self.mp, sources=self.sources,
                       dt_limit=self.dt_limit,
                       wind_sources=self.wind_sources).setup(cfg, geom)

    def _ds0(self, i: int, src: Source, Ph):
        """Path length through every cell for source ``i``."""
        if src.at_infinity:
            return torch.full_like(Ph[RO], self.raytracer.geom.dx)
        return self.raytracer.static_fields(i, Ph)[0]

    def trace_taus(self, Ph, tau_in: Optional[Dict] = None) -> Dict:
        """Per-source entry optical depths (incl. any upstream offsets) —
        what a nested-grid hierarchy hands down to child levels (reference: NG
        C2F boundary data carries Tau/dTau extra_data)."""
        out: Dict = {}
        for i, src in enumerate(self.sources):
            dtau = self.dtau_for(src, Ph, self._ds0(i, src, Ph))
            tau, _, _ = self.raytracer.trace_source(i, dtau)
            if tau_in is not None and i in tau_in:
                tau = tau + tau_in[i]
            out[i] = tau
        return out

    def update_sources(self, t: float) -> Optional[Dict]:
        """Evolving-source update: interpolate each source's evolution
        table at t and build the per-source parameter dict (reference:
        update_evolving_RT_sources, setup_fixed_grid.cpp:695-790 —
        re-applied only when L or T move >1%; mfion tables re-integrated
        via set_multifreq_source_properties).  Host-side, once per step.
        Returns None when no source evolves.  ``rel`` is a float and
        ``tau_stack`` a float64 numpy array; :meth:`raytrace` casts them."""
        if not any(s.evolution is not None for s in self.sources):
            return None
        if not hasattr(self, "_star"):
            self._star = {}
        sp: Dict = {}
        for i, src in enumerate(self.sources):
            if src.evolution is None:
                continue
            L, T, R = src.evolution.at(t)
            st = self._star.get(i)
            if (st is None or abs(L - st["L"]) / st["L"] > 0.01
                    or abs(T - st["T"]) / st["T"] > 0.01):
                st = {"L": L, "T": T, "R": R}
                if src.effect == "mfion":
                    stack, ls = self.mp.set_multifreq_source_properties(T, R)
                    st["tau_stack"] = stack
                    # rel is relative to whatever log-scale raytrace bakes
                    # into sv for THIS source (its own static table's peak
                    # if it has one, else the module's)
                    base = getattr(self, "_src_static", {}).get(
                        i, {}).get("ls", self.mp.rate_scale_log)
                    st["rel"] = float(np.exp(np.log(10.0) * (ls - base)))
                elif src.effect == "uv_heating":
                    # reference's FUV-strength prescription
                    # (setup_fixed_grid.cpp:769-772)
                    st["rel"] = float(1.0e48 * (L / 1.989e38)
                                      * np.exp(-1.0e4 / T) / src.strength)
                else:  # mono: strength follows L (reference sets
                    # rs->strength = Lnow for every evolving source)
                    st["rel"] = float(L / src.strength)
                self._star[i] = st
            entry = {"rel": st["rel"]}
            if "tau_stack" in st:
                entry["tau_stack"] = st["tau_stack"]
            sp[str(i)] = entry
        return sp

    def device_sp(self, sp: Optional[Dict], like: torch.Tensor):
        """``sp`` of :meth:`update_sources` on ``like``'s device in its
        dtype, as :meth:`raytrace` reads it inside a step: ``rel`` a 0-d
        tensor (a fill, not a copy), ``tau_stack`` a tensor kept while
        ``update_sources`` hands the same table.  None stays None."""
        if sp is None:
            return None
        if not hasattr(self, "_sp_kept"):
            self._sp_kept = {}
        out: Dict = {}
        for k, e in sp.items():
            d = {"rel": torch.full((), float(e["rel"]), dtype=like.dtype,
                                   device=like.device)}
            if "tau_stack" in e:
                key = (k, like.dtype, like.device)
                kept = self._sp_kept.get(key)
                if kept is None or kept[0] is not e["tau_stack"]:
                    kept = (e["tau_stack"], torch.as_tensor(
                        e["tau_stack"], dtype=like.dtype, device=like.device))
                    self._sp_kept[key] = kept
                d["tau_stack"] = kept[1]
            out[k] = d
        return out

    def _static_stack(self, i: int, like: torch.Tensor):
        """Source ``i``'s own tau table, made once per dtype and device."""
        key = ("stack", i, like.dtype, like.device)
        if key not in self._rate_cache:
            self._rate_cache[key] = torch.as_tensor(
                self._src_static[i]["stack"], dtype=like.dtype,
                device=like.device)
        return self._rate_cache[key]

    def _rate_factors(self, i: int, src: Source, Ph):
        """``(nv, sv)`` of source ``i``: Ndot/Vshell and 10^ls/Vshell, from
        the static tracer geometry on the host at float64, cast to the
        state's dtype and kept per dtype and device."""
        key = (i, Ph.dtype, Ph.device)
        if key not in self._rate_cache:
            if src.at_infinity:
                vsh_np = np.float64(self.raytracer.geom.dx)
            else:
                vsh_np = self.raytracer.point_tracers[i].vshell
            nv = torch.as_tensor(np.float64(src.strength) / vsh_np,
                                 dtype=Ph.dtype, device=Ph.device)
            sv = None
            if src.effect in ("mono", "mfion"):
                static = self._src_static.get(i)
                ls = (static["ls"] if static is not None
                      else getattr(self.mp, "rate_scale_log", 0.0))
                sv = torch.as_tensor(
                    np.exp(np.log(10.0) * (ls - np.log10(vsh_np))),
                    dtype=Ph.dtype, device=Ph.device)
            self._rate_cache[key] = (nv, sv)
        return self._rate_cache[key]

    def raytrace(self, Ph, tau_in: Optional[Dict] = None,
                 sp: Optional[Dict] = None) -> Dict:
        """Trace all sources through the current state; assemble the rt dict
        (reference: setup_radiation_source_parameters, MPv3.cpp:1431-1516).
        ``tau_in`` optionally adds per-source upstream column offsets (for
        nested-grid levels whose domain does not reach the ray origin).
        ``sp``: evolving-source parameters from :meth:`update_sources`, with
        host numbers and numpy tables, or from :meth:`device_sp`, which
        copies nothing inside a step."""
        rt: Dict = {}
        g0_uv = None
        g0_ir = None

        def table(a):
            return torch.as_tensor(a, dtype=Ph.dtype, device=Ph.device)

        for i, src in enumerate(self.sources):
            rel = None
            if sp is not None and str(i) in sp:
                rel = sp[str(i)]["rel"]
                if not isinstance(rel, torch.Tensor):
                    rel = float(rel)
            dtau = self.dtau_for(src, Ph, self._ds0(i, src, Ph))
            tau, ds, vshell = self.raytracer.trace_source(i, dtau)
            if tau_in is not None and i in tau_in:
                tau = tau + tau_in[i]
            nv, sv = self._rate_factors(i, src, Ph)
            if rel is not None:
                nv = nv * rel
            if src.effect in ("mono", "mfion"):
                static = self._src_static.get(i)
                if rel is not None:
                    sv = sv * rel
                entry = {"tau0": tau, "ds": ds, "nv": nv, "sv": sv}
                if static is not None:
                    entry["tau_stack"] = self._static_stack(i, Ph)
                if sp is not None and str(i) in sp \
                        and "tau_stack" in sp[str(i)]:
                    entry["tau_stack"] = table(sp[str(i)]["tau_stack"])
                rt.setdefault("ion", ())
                rt["ion"] = rt["ion"] + (entry,)
                # legacy single-source top-level fields (first entry)
                if "tau0" not in rt:
                    rt.update(tau0=tau, ds=ds, vshell=vshell,
                              n_idot=src.strength, nv=nv, sv=sv)
                    if "tau_stack" in entry:
                        rt["tau_stack"] = entry["tau_stack"]
            else:  # uv_heating (Henney+09 A3/A6 attenuation; /1.2e7 norm)
                if src.at_infinity:
                    # diffuse field: solid-angle weighted
                    # (reference: MPv3::setup_diffuse_RT_angle, :585-640)
                    cfg = self.raytracer.cfg
                    if cfg.ndim == 3:
                        angle = 4.0 * np.pi / 6.0
                    elif cfg.ndim == 2 and cfg.coords is Coord.CYLINDRICAL:
                        angle = (16.0 * np.pi / 6.0 if src.axis == 0
                                 else 4.0 * np.pi / 6.0)
                    elif cfg.ndim == 2:
                        angle = 2.0 * np.pi / 4.0
                    else:
                        angle = 1.0
                    flux = src.strength * angle
                    if rel is not None:
                        flux = flux * rel
                else:
                    flux = nv * ds
                uv = flux * torch.exp(-1.90 * tau)
                ir = flux * torch.exp(-0.05 * tau)
                g0_uv = uv if g0_uv is None else g0_uv + uv
                g0_ir = ir if g0_ir is None else g0_ir + ir
        z = torch.zeros_like(Ph[RO])
        rt.setdefault("tau0", z + 1.0e6)
        rt.setdefault("ds", z)
        if "vshell" not in rt:
            # 1e200 is inf in float32 (see the module docstring)
            rt["vshell"] = torch.full_like(z, float("inf")) \
                if z.dtype == torch.float32 else z + 1.0e200
        rt.setdefault("n_idot", 0.0)
        rt["g0_uv"] = (g0_uv / 1.2e7) if g0_uv is not None else z
        rt["g0_ir"] = (g0_ir / 1.2e7) if g0_ir is not None else z
        return rt

    def mp_delta_U(self, P, Ph, dt, cfg: SimConfig, tau_in=None, rt=None,
                   sp=None):
        """Conserved-variable increment from the chemistry update
        (reference: calc_RT_microphysics_dU — dU += U(p_out)-U(p_in),
        time_integrator.cpp:430-497; base state is P, columns from Ph).
        ``rt``: optionally reuse a column set already traced through Ph —
        the reference likewise raytraces once per partial update
        (time_integrator.cpp:206-243) and hands the stored columns to MP."""
        if rt is None:
            rt = (self.raytrace(Ph, tau_in, sp=sp) if self.sources
                  else self.mp.default_rt(P))
        P_new = self.mp._update_impl(P, dt, cfg, rt)
        return prim_to_cons(P_new, cfg) - prim_to_cons(P, cfg)

    def timescale(self, P, cfg: SimConfig, tau_in=None, rt=None, sp=None,
                  with_ydot=False):
        """The chemistry timestep limit as a 0-d tensor.

        Two behaviours are copied from the JAX package as they are:
        ``dt_limit`` modes 1-4 all give MPv3's own limit at the module's
        ``dtlimit_tier`` (tier 6 by default, where PION compiles tier 2),
        and a mode that is none of 0-4 (an unknown ``MP_timestep_limit``)
        silently disables the limit: it returns 1e99."""
        mode = int(self.dt_limit)
        procs = getattr(self.mp, "dt_limit_processes",
                        ("cooling", "recomb", "ion"))
        mode_procs = {1: ("cooling",), 2: ("cooling", "recomb"),
                      3: ("cooling", "recomb", "ion"), 4: ("recomb",)}
        if mode != 0 and not set(mode_procs.get(mode, ())) & set(procs):
            # e.g. mode 4 (recomb only) with a cooling-only module:
            # no applicable process -> no chemistry limit
            big = torch.full((), 1.0e99 if P.dtype == torch.float64
                             else float("inf"), dtype=P.dtype,
                             device=P.device)
            if with_ydot:
                # no usable ydot to seed the update with
                return big, None
            return big
        if rt is None:
            rt = (self.raytrace(P, tau_in, sp=sp) if self.sources
                  else self.mp.default_rt(P))
        if "with_ydot" in inspect.signature(
                self.mp._timescales_impl).parameters:
            return self.mp._timescales_impl(P, cfg, rt, with_ydot=with_ydot)
        ts = self.mp._timescales_impl(P, cfg, rt)
        return (ts, None) if with_ydot else ts

    def wind_exclude_mask(self, like: Optional[torch.Tensor] = None):
        """Union of the (static) wind-region masks — cells the CFL dt
        reduction skips, like the reference's internal-boundary isbd flag
        (calc_timestep.cpp calc_dynamics_dt).  Orbiting sources move, so
        their cells stay in the reduction (conservative).  A bool tensor on
        ``like``'s device (the CPU without ``like``), or None without a
        static wind."""
        static = [w for w in self.winds if not w.src.orbits]
        if not static:
            return None
        device = torch.device("cpu") if like is None else like.device
        if device not in self._excl_cache:
            mask = None
            for w in static:
                m = w.mask.to(device)
                mask = m if mask is None else (mask | m)
            self._excl_cache[device] = mask
        return self._excl_cache[device]

    def wind_dt_cap(self, cfg, geom) -> float:
        """First-step dt ceiling from the wind speeds (reference:
        calc_dynamics_dt "if on first step and stellar winds present",
        dt <= 0.1 CFL dx / Vinf)."""
        cap = float("inf")
        for s in self.wind_sources:
            if s.vinf > 0.0:
                cap = min(cap, 0.1 * cfg.cfl * geom.dx / s.vinf)
        return cap
