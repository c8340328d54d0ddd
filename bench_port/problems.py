"""A cell's inputs and the run that steps them, from its configuration file
and traffic mix.

The inputs (one primitive state a level, as float64 numpy) are made here from
the seed, with the reference's own constants and initial conditions, and the
same arrays go to the program and to the reference.  ``make_run`` builds the
run of either package from the same configuration: ``pion_tpu_torch`` (the
program) or the configuration's reference package, whose public interfaces
are the same.

The reference is the package ``bench_port/reference/<name>/`` that the file
names under ``reference`` (default ``port_plain``), resolved by
:func:`reference_of` alone.  A reference package offers ``port_plain``'s
public interface: ``SimConfig``, ``Simulation``, ``NGHierarchy``,
``WindSource`` and the submodules ``constants``, ``microphysics``,
``physics``, ``raytracing`` and ``ics``.  It may import the frozen
``port_plain`` to share its unchanged modules, and imports nothing of the
program and no JAX.

A file may also name a builder, ``bench_port/builders/<name>.py``, under
``builder``, which defines ``initial_states(ref, config, traffic, seed)``:
one float64 primitive state a level, made with the reference package
``ref``.  So a configuration brings its own initial condition and traffic
shaping as new files.  The physics, the lead steps and the cell-updates of
a step are the functions here for every configuration.

Configuration file keys read here:

- ``sim``: the fields of ``SimConfig`` (lists for tuples);
- ``reference``, ``builder`` (optional): the names above;
- ``initial``: ``{"kind": "uniform_medium", "nH", "T", "B_gauss", "x0"}``
  (a neutral medium, field in gauss, ionised fraction ``x0`` in the first
  tracer) or ``{"kind": "blast", "rho0", "p0", "p_in", "r_in", "B0",
  "tracer_in"}`` (the MHD blast; the tracer ``tracer_in`` inside ``r_in``);
- ``chemistry`` (optional): the ``MPv3Config`` fields, ``rstar_rsun`` for
  ``rstar_cm``, and ``dt_limit``;
- ``sources``, ``winds`` (optional): point sources and stellar winds, their
  positions as fractions of the domain, a wind's radius in cells of the
  finest level and its mass-loss rate in solar masses a year.  Sources need
  a chemistry; winds do not.

Traffic keys read here: ``noise`` (the amplitude of icgen's density noise)
and ``front`` (optional: ``{"radius_level0_cells", "x", "T"}``, a sphere
around the centre ionised and heated, its radius in level-0 cells).
"""
from __future__ import annotations

import math
from importlib import import_module

import numpy as np

RO, PG, BX = 0, 1, 5
DEFAULT_REFERENCE = "port_plain"


def _name(config: dict, key: str, default=None):
    name = config.get(key, default)
    if name is not None and not name.isidentifier():
        raise ValueError(f"{key} {name!r} is not a module name")
    return name


def reference_of(config: dict):
    """The reference package the configuration names:
    ``bench_port/reference/<reference>/``, ``port_plain`` by default."""
    name = _name(config, "reference", DEFAULT_REFERENCE)
    return import_module(f"{__package__}.reference.{name}")


def builder_of(config: dict):
    """The module ``bench_port/builders/<builder>.py`` the configuration
    names, or None."""
    name = _name(config, "builder")
    return None if name is None else import_module(
        f"{__package__}.builders.{name}")


def submodule(pkg, name: str):
    """``pkg``'s submodule ``name``: its attribute where it has one (a
    reference that re-exports another's), else imported."""
    mod = getattr(pkg, name, None)
    return (mod if mod is not None
            else import_module(pkg.__name__ + "." + name))


def _rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a seed; any whole number is a seed."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def _medium(ref, cfg, ini: dict, mpc) -> np.ndarray:
    """A uniform neutral medium (the H II region of the Ostar3D class)."""
    K_B = submodule(ref, "constants").K_B
    P = np.zeros((cfg.nvar,) + cfg.shape)
    nH = float(ini["nH"])
    P[RO] = nH * mpc.mean_mass_per_h
    # neutral gas: hydrogen and helium atoms, 1.1 particles an H nucleon
    P[PG] = 1.1 * nH * K_B * float(ini["T"])
    for a, b in enumerate(ini.get("B_gauss", (0.0, 0.0, 0.0))):
        P[BX + a] = float(b) / math.sqrt(4.0 * math.pi)
    P[cfg.eqn.nbase] = float(ini["x0"])
    return P


def _front(ref, P: np.ndarray, cfg, front: dict, level: int, mpc) -> None:
    """Ionise and heat a sphere around the grid's centre in place (the
    developed H II region of ``front_state``): radius in level-0 cells, so
    ``2**level`` times that in this level's cells."""
    K_B = submodule(ref, "constants").K_B
    n = cfg.shape[0]
    ax = np.arange(n) - (n - 1) / 2.0
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                + ax[None, None, :] ** 2)
    inside = r < float(front["radius_level0_cells"]) * 2 ** level
    x = float(front["x"])
    P[cfg.eqn.nbase][inside] = x
    nH = P[RO] / mpc.mean_mass_per_h
    P[PG][inside] = ((mpc.n_ion + mpc.n_elec * x) * nH * K_B
                     * float(front["T"]))[inside]


def _blast(ref, cfg, ini: dict) -> np.ndarray:
    P = submodule(ref, "ics").blast_wave(
        cfg, rho0=ini["rho0"], p0=ini["p0"], p_in=ini["p_in"],
        r_in=ini["r_in"], B0=tuple(ini["B0"]))
    if cfg.ntracer:
        # the blast's own material: where blast_wave set the inner pressure
        P[cfg.eqn.nbase] = np.where(P[PG] == ini["p_in"],
                                    float(ini["tracer_in"]), 0.0)
    return P


def sim_config(pkg, config: dict, kernels: str = "auto"):
    """``pkg.SimConfig`` of the configuration file."""
    fields = dict(config["sim"])
    for k in ("shape", "xmin", "xmax"):
        fields[k] = tuple(fields[k])
    fields["bcs"] = tuple(tuple(f) for f in fields["bcs"])
    return pkg.SimConfig(kernels=kernels, **fields)


def chemistry_config(pkg, config: dict, cfg):
    """``pkg``'s ``MPv3Config`` of the configuration file, its ionised
    fraction in the first tracer."""
    chem = dict(config["chemistry"])
    chem.pop("class")
    chem.pop("dt_limit", None)
    rsun = chem.pop("rstar_rsun", None)
    if rsun is not None:
        chem["rstar_cm"] = rsun * submodule(pkg, "constants").RSUN
    return submodule(pkg, "microphysics").MPv3Config(
        tracer_slot=cfg.eqn.nbase, **chem)


def initial_states(config: dict, traffic: dict, seed: int) -> list:
    """One float64 primitive state a level, from the seed: the builder's
    where the configuration names one; else the configuration's initial
    condition, the mix's front, then icgen's density noise
    (``ics/icgen.cpp:257``), one stream a level."""
    ref = reference_of(config)
    builder = builder_of(config)
    if builder is not None:
        return builder.initial_states(ref, config, traffic, seed)
    cfg0 = sim_config(ref, config, kernels="off")
    ini = config["initial"]
    nlev = cfg0.nlevels
    mpc = (chemistry_config(ref, config, cfg0) if "chemistry" in config
           else None)
    states = []
    for level in range(nlev):
        if ini["kind"] == "uniform_medium":
            P = _medium(ref, cfg0, ini, mpc)
        elif ini["kind"] == "blast":
            P = _blast(ref, cfg0, ini)
        else:
            raise ValueError(f"unknown initial condition {ini['kind']!r}")
        if traffic.get("front"):
            _front(ref, P, cfg0, traffic["front"], level, mpc)
        amp = float(traffic.get("noise", 0.0))
        if amp:
            P[RO] *= 1.0 + amp * (_rng(seed, level).random(cfg0.shape) - 0.5)
        states.append(P)
    return states


def _physics(pkg, config: dict, cfg):
    """``pkg``'s ``Physics`` of the chemistry, sources and winds of the
    file, or None where it has none of them."""
    chem = config.get("chemistry")
    if chem is None and config.get("sources"):
        raise ValueError("point sources need a chemistry to act on")
    if chem is None and not config.get("winds"):
        return None
    const = submodule(pkg, "constants")
    physics = submodule(pkg, "physics")

    def at(frac):
        return tuple(lo + f * (hi - lo)
                     for f, lo, hi in zip(frac, cfg.xmin, cfg.xmax))

    fine_dx = cfg.dx / 2 ** (cfg.nlevels - 1)
    winds = [pkg.WindSource(
        position=at(w["position_frac"]),
        radius=w["radius_finest_cells"] * fine_dx,
        mdot=w["mdot_msun_yr"] * const.MSUN / const.YEAR, vinf=w["vinf"],
        t_wind=w["t_wind"], b_star=w["b_star"], tracers=tuple(w["tracers"]))
        for w in config.get("winds", [])]
    if chem is None:
        return physics.Physics(mp=None, wind_sources=winds)
    rt = submodule(pkg, "raytracing")
    mpc = chemistry_config(pkg, config, cfg)
    mp = getattr(submodule(pkg, "microphysics"), chem["class"])(mpc)
    sources = [rt.Source(position=at(s["position_frac"]),
                         strength=s["strength"], effect=s["effect"])
               for s in config.get("sources", [])]
    return physics.Physics(mp=mp, sources=sources,
                           dt_limit=chem.get("dt_limit", True),
                           wind_sources=winds)


def make_run(pkg, config: dict, states: list, kernels: str = "auto",
             device=None):
    """The configuration's run in package ``pkg`` on ``states``: a
    ``Simulation`` for one level, an ``NGHierarchy`` for several."""
    cfg = sim_config(pkg, config, kernels)
    physics = _physics(pkg, config, cfg)
    if cfg.nlevels == 1:
        return pkg.Simulation(cfg, states[0], physics=physics,
                              device=device)
    hier = pkg.NGHierarchy(cfg, physics=physics, device=device)
    hier.set_states(states)
    return hier


def lead_steps(config: dict) -> int:
    """Single steps taken in set-up before the episode: a run with winds
    takes its first step alone (the first-step wind cap), so the episode
    starts after it and is all chunks."""
    return 1 if config.get("winds") else 0


def cells_per_step(config: dict) -> int:
    """Cell-updates of one step: each level's cells, level l counted 2^l
    times (it takes 2^l substeps a hierarchy step)."""
    cells = int(np.prod(config["sim"]["shape"]))
    return sum(cells * 2 ** l for l in range(config["sim"].get("nlevels", 1)))
