"""The Euler slice: the plain sweep with every Euler solver and with the MHD
linear/Roe solvers, the kernels' scope against the Pallas kernels in
interpret mode, the shock-tube initial conditions, and runs of the whole
system against the JAX package — Sod, a 3D Euler blast, the photoionised
Euler wind bubble and a 2-level Euler hierarchy.  CPU, float64 unless a test
says otherwise."""
import dataclasses
import importlib
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.boundaries import BoundaryData as RefBoundaryData
from pion_tpu.boundaries import apply_bcs as ref_apply_bcs
from pion_tpu.constants import MSUN, YEAR
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.ng import NGHierarchy as RefHierarchy
from pion_tpu.ops import pallas_sweep as ref_pallas
from pion_tpu.ops import riemann_hydro as ref_rh
from pion_tpu.ops import sweep as ref_sweep
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.raytracing import Source as RefSource
from pion_tpu.winds import WindSource as RefWindSource

import pion_tpu_torch
from pion_tpu_torch import Simulation, convert, ics
from pion_tpu_torch.boundaries import apply_bcs
from pion_tpu_torch.constants import K_B, PG, RO
from pion_tpu_torch.ops import fused_sweep, sweep

from test_torch_eqns import close, noisy_state, to_port
from test_torch_ng import level_states, scales

torch.set_num_threads(1)

# the modules, not the functions of the same name that ``ics`` exports
ref_st = importlib.import_module("pion_tpu.ics.shocktube")
st = importlib.import_module("pion_tpu_torch.ics.shocktube")

DT = 1.0e-3


def box(shape, **kw):
    nd = len(shape)
    base = dict(ndim=nd, shape=tuple(shape), xmin=(0.0,) * nd,
                xmax=tuple(s / shape[-1] for s in shape),
                bcs=(("outflow", "outflow"),) * nd, cfl=0.3, ooa=2,
                gamma=1.4)
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def _pair(rcfg, seed):
    """Both packages' padded state of a seeded noisy blast."""
    P = noisy_state(rcfg, seed)
    cfg, Pt, bd = to_port(rcfg, P)
    rPpad = ref_apply_bcs(jnp.asarray(P), rcfg, RefBoundaryData())
    Ppad = apply_bcs(Pt, cfg, bd)
    return (cfg, pion_tpu_torch.make_geometry(cfg), Ppad,
            pion_tpu.make_geometry(rcfg), rPpad)


# (shape, av, order) of each plain-sweep case: 2D and 3D, both AVs, both
# orders.  Square and cubic, so that every axis's sweep has the same shapes
# and the JAX package compiles its operations once for all of them.
SWEEP_CASES = [((8, 8), "falle", 2), ((8, 8), "none", 1),
               ((6, 6, 6), "none", 2), ((6, 6, 6), "falle", 1)]
EULER_SOLVERS = ["hll", "linear", "roe", "roe_pv", "exact", "hybrid", "fvs",
                 "lf"]


@pytest.mark.parametrize("solver", EULER_SOLVERS)
def test_euler_dynamics_dU_matches_xla_sweep(solver):
    """dU and every face flux of the plain sweep against the JAX package's
    XLA sweep at 1e-12, for each Euler solver with one tracer."""
    for i, (shape, av, order) in enumerate(SWEEP_CASES):
        rcfg = box(shape, eqn="euler", solver=solver, ntracer=1, av=av)
        cfg, geom, Ppad, rgeom, rPpad = _pair(rcfg, 20 + i)
        dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order)
        rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order)
        close(dU, rdU, rtol=1e-12, atol=1e-14)
        for f, rf in zip(faces, rfaces):
            close(f, rf, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("eqn,solver", [("mhd", "linear"), ("glm", "linear"),
                                        ("mhd", "roe"), ("glm", "roe"),
                                        ("mhd", "roe_pv"), ("glm", "roe_pv")])
def test_mhd_linear_and_roe_dynamics_dU_match_xla_sweep(eqn, solver):
    """The MHD linear/Roe branches of the plain sweep (``roe_pv`` runs the
    linear solver for MHD, as in the reference) at 1e-12.  The absolute
    floor is 1e-13 of the fluxes' unit scale: the linear solver's star
    state sums seven waves' terms that cancel to 1e-2 of their size (read:
    1.6e-14 in one face of 936)."""
    for i, (shape, av, order) in enumerate(SWEEP_CASES[:3]):
        # MHD with two tracers has GLM's ten variables: shared compiles
        rcfg = box(shape, eqn=eqn, solver=solver, av=av, gamma=5.0 / 3.0,
                   ntracer=2 if eqn == "mhd" else 1)
        cfg, geom, Ppad, rgeom, rPpad = _pair(rcfg, 30 + i)
        dU, faces = sweep.dynamics_dU(Ppad, cfg, geom, DT, order)
        rdU, rfaces = ref_sweep.dynamics_dU(rPpad, rcfg, rgeom, DT, order)
        close(dU, rdU, rtol=1e-12, atol=1e-15)
        for f, rf in zip(faces, rfaces):
            close(f, rf, rtol=1e-12, atol=1e-13)
    if solver == "roe_pv":
        lin = dataclasses.replace(cfg, solver=pion_tpu_torch.Solver.LINEAR)
        assert torch.equal(sweep.dynamics_dU(Ppad, lin, geom, DT, order)[0],
                           dU)


@pytest.mark.parametrize("eqn,solver", [
    ("euler", "hll"), ("euler", "linear"), ("euler", "roe"),
    ("euler", "roe_pv"), ("mhd", "linear"), ("glm", "roe")])
def test_kernel_scope_matches_pallas_interpret(eqn, solver):
    """The plain versions of the kernels (``sweep_axis_plain`` summed over
    the axes) against the JAX package's fused kernels in interpret mode at
    1e-10, over the kernels' new scope: Euler HLL/linear/Roe-CV/Roe-PV and
    MHD linear/Roe-CV; 2D, Falle AV, order 2, one tracer, with and without
    the sCMA clamp."""
    rcfg = box((8, 8), eqn=eqn, solver=solver, ntracer=1, av="falle",
               gamma=1.4 if eqn == "euler" else 5.0 / 3.0)
    cfg, geom, Ppad, rgeom, rPpad = _pair(rcfg, 40)
    assert fused_sweep.supports(cfg) and ref_pallas.supports(rcfg)
    # the sCMA clamp on every other case (the wind path's variant)
    scma = solver in ("linear", "roe_pv") or eqn == "glm"
    ref = ref_pallas.dynamics_dU_pallas(rPpad, rcfg, rgeom, DT, 2,
                                        interpret=True, scma=scma)
    out = sum(fused_sweep.sweep_axis_plain(Ppad, cfg, geom, a, 2, DT,
                                           scma=scma)
              for a in range(cfg.ndim))
    close(out, ref, rtol=1e-10, atol=1e-13)


# ---------------------------------------------------------------------------
# shock tubes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("number", [1, 2, 3, 4, 5])
def test_toro_tests_equal_the_reference(number):
    """``toro_tests`` 1-5 bit for bit: 1D (the smoothed interface), 2D and
    3D at 0 and at 45 degrees (the rotated interface and states)."""
    for shape in ((64,), (8, 16), (4, 8, 16)):
        rcfg = box(shape, eqn="euler", ntracer=1)
        cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
        for angle in ((0.0,) if len(shape) == 1 else (0.0, np.pi / 4)):
            got = ics.toro_tests(cfg, number, angle_xy=angle)
            want = ref_st.toro_tests(rcfg, number, angle_xy=angle)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert st.test_meta(number) == ref_st.test_meta(number)


def test_brio_wu_and_the_mhd_menu():
    for shape in ((64,), (8, 16)):
        rcfg = box(shape, eqn="glm", ntracer=1)
        cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
        for angle in ((0.0,) if len(shape) == 1 else (0.0, np.pi / 4)):
            assert np.array_equal(ics.brio_wu(cfg, angle_xy=angle),
                                  ref_st.brio_wu(rcfg, angle_xy=angle))
        for number in (8, 13, 19) if len(shape) == 1 else (13,):
            assert np.array_equal(st.predefined_test(cfg, number),
                                  ref_st.predefined_test(rcfg, number))
    euler = convert.config_from_reference(dataclasses.asdict(
        box((64,), eqn="euler")))
    with pytest.raises(ValueError, match="needs MHD"):
        ics.brio_wu(euler)


# ---------------------------------------------------------------------------
# the system as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["hll", "roe"])
def test_sod_to_tmax_matches_reference(solver):
    """Toro test 1 (Sod), 1D, 64 cells, ``Simulation.run`` to the problem's
    tmax: fields at 1e-9, dt and t at 1e-12; and the star pressure of the
    plateau against ``exact_pstar`` of the initial states."""
    gamma, tmax = st.test_meta(1)
    rcfg = box((64,), eqn="euler", solver=solver, gamma=gamma, tmax=tmax)
    P0 = ref_st.toro_tests(rcfg, 1)
    rdts, dts = [], []
    ref = pion_tpu.Simulation(rcfg, P0.copy())
    ref.run(callback=lambda s: rdts.append(s.last_dt))
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    sim = Simulation(cfg, st.toro_tests(cfg, 1), device="cpu")
    sim.run(callback=lambda s: dts.append(s.last_dt))
    assert sim.step_count == ref.step_count > 20
    np.testing.assert_allclose(dts, rdts, rtol=1e-12)
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-12)
    assert sim.t == pytest.approx(tmax, rel=1e-12)
    want = np.asarray(ref.P)
    got = sim.P.numpy()
    for v in range(cfg.nvar):
        assert np.abs(got[v] - want[v]).max() <= 1e-9 * max(
            np.abs(want[v]).max(), np.abs(want[2:5]).max()), v
    # the plateau between contact and shock holds p* within 3 %
    l, r = (np.array(RIEMANN[k][:5]) for k in (0, 1))
    pstar, _ = ref_rh.exact_pstar(jnp.asarray(l[:, None]),
                                  jnp.asarray(r[:, None]), rcfg)
    x = cfg.cell_centers(0)
    plateau = (x > 0.45) & (x < 0.65)
    np.testing.assert_allclose(got[PG][plateau], float(pstar[0]), rtol=0.03)


RIEMANN = ref_st.RIEMANN_TESTS[1]


def test_euler_blast_3d_five_steps():
    """A 3D Euler blast at 12^3 with one tracer and Falle AV (seeded noise,
    a random tracer), five steps of ``Simulation.run`` against the JAX
    package at 1e-8; the port runs its kernels' plain versions (``auto`` on
    a CPU tensor) and the reference its XLA sweep."""
    rcfg = box((12, 12, 12), eqn="euler", solver="hll", ntracer=1,
               av="falle", etav=0.1)
    P = noisy_state(rcfg, 50)
    ref = pion_tpu.Simulation(rcfg, P.copy()).run(max_steps=5)
    cfg, Pt, _ = to_port(rcfg, P)
    cfg = dataclasses.replace(cfg, kernels="auto")
    assert fused_sweep.supports(cfg)
    sim = Simulation(cfg, Pt, device="cpu").run(max_steps=5)
    assert sim.step_count == ref.step_count == 5
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-12)
    close(sim.P, ref.P, rtol=1e-8, atol=1e-11)


def test_solvers_without_a_kernel_take_the_plain_sweep(monkeypatch):
    """``lf``, ``exact``, ``hybrid`` and ``fvs`` lie outside
    ``fused_sweep.supports``: a run with ``kernels="auto"`` routes them to
    the plain sweep by configuration, before any launch; the kernels'
    solvers go through the fused wrappers."""
    calls = []
    real = fused_sweep.advance_dynamics

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fused_sweep, "advance_dynamics", counted)
    for solver in ["lf", "exact", "hybrid", "fvs", "hll", "linear", "roe",
                   "roe_pv"]:
        rcfg = box((8, 12), eqn="euler", solver=solver, ntracer=1)
        cfg, Pt, _ = to_port(rcfg, noisy_state(rcfg, 51))
        cfg = dataclasses.replace(cfg, kernels="auto")
        n0 = len(calls)
        sim = Simulation(cfg, Pt, device="cpu").run(max_steps=1)
        assert bool(torch.isfinite(sim.P).all())
        kernel = solver in ("hll", "linear", "roe", "roe_pv")
        assert fused_sweep.supports(cfg) == kernel
        assert (len(calls) - n0) == (2 if kernel else 0), solver


# the photoionised Euler wind bubble of the reference's sharded smoke run
N = 12
L = 3.0e18


def wind_setup(dtype="float64"):
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="euler", solver="hll", ntracer=1, shape=(N,) * 3,
        xmin=(0.0,) * 3, xmax=(L,) * 3, bcs=(("outflow", "outflow"),) * 3,
        cfl=0.3, ooa=2, av="falle", etav=0.1, dtype=dtype,
        min_temperature=50.0, tmax=1.0e16)
    mpc = RefMPv3Config(tracer_slot=rcfg.eqn.nbase, ion_src="mono",
                        n_idot=1.0e48, min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    src = RefSource(position=ctr, strength=1.0e48, effect="mono")
    wind = RefWindSource(position=ctr, radius=2.5 * rcfg.dx,
                         mdot=1.0e-7 * MSUN / YEAR, vinf=2.0e8, t_wind=3.0e4,
                         tracers=(1.0,))
    nH = 10.0
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 100.0
    P0[rcfg.eqn.nbase] = 1.0e-6
    return rcfg, mpc, src, wind, P0


def wind_port_run(rcfg, mpc, src, wind, P0, steps):
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    cfg = dataclasses.replace(cfg, kernels="auto")
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(src)], dt_limit=True,
        wind_sources=[dataclasses.asdict(wind)])
    dts = []
    sim = Simulation(cfg, P0.copy(), physics=phys, device="cpu")
    sim.run(max_steps=steps, callback=lambda s: dts.append(s.last_dt))
    return sim, dts


@pytest.fixture(scope="module")
def wind_run():
    """The port's float64 run of the wind bubble, two steps (the kernels'
    plain versions, the chemistry's per-tile ladder among them: ~15 s)."""
    return wind_port_run(*wind_setup(), 2)


def test_euler_wind_bubble_matches_reference(wind_run):
    """Euler + HLL + MPv3 ``mono`` + a point source + a stellar wind at
    12^3, two steps against the JAX ``Simulation``: dt and t at 1e-9, the
    fields at 1e-7 of each variable's range (the velocity of the whole
    vector), as the H II run is held."""
    rcfg, mpc, src, wind, P0 = wind_setup()
    rdts = []
    ref = pion_tpu.Simulation(rcfg, P0.copy(), physics=RefPhysics(
        mp=RefMPv3(mpc), sources=[src], wind_sources=[wind], dt_limit=True))
    ref.run(max_steps=2, callback=lambda s: rdts.append(s.last_dt))
    sim, dts = wind_run
    assert sim.step_count == ref.step_count == 2
    np.testing.assert_allclose(dts, rdts, rtol=1e-9)
    np.testing.assert_allclose(sim.t, ref.t, rtol=1e-9)
    got, want = sim.P.numpy(), np.asarray(ref.P)
    sc = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    sc[2:5] = sc[2:5].max()
    for v in range(rcfg.nvar):
        assert np.abs(got[v] - want[v]).max() <= 1e-7 * sc[v], v
    # the source did work, the wind region holds the wind
    xs = rcfg.eqn.nbase
    assert got[xs].max() > 10 * P0[xs].max()
    w = sim.physics.winds[0]
    m = torch.from_numpy(w._geo_np["inner"])
    assert (got[RO][m.numpy()] < 1e-3 * P0[RO].max()).all()


def test_euler_wind_bubble_float32_without_warnings(wind_run):
    """float32 with every warning an error (no overflow or invalid value in
    a cast or a numpy operation); finite, x in [0, 1], T >= 50 K away from
    the wind, and the same run as the float64 one to float32 rounding."""
    rcfg, mpc, src, wind, P0 = wind_setup(dtype="float32")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warnings.filterwarnings("ignore", message=".*torch.jit.script.*",
                                category=DeprecationWarning)
        with np.errstate(over="raise", invalid="raise"):
            sim, dts = wind_port_run(rcfg, mpc, src, wind, P0, 2)
    assert sim.P.dtype == torch.float32 and sim.step_count == 2
    assert bool(torch.isfinite(sim.P).all()) and all(d > 0 for d in dts)
    x = sim.P[rcfg.eqn.nbase]
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    T = sim.physics.mp.temperature(sim.P, sim.cfg)
    away = ~torch.from_numpy(sim.physics.winds[0]._geo_np["mask"])
    assert 50.0 * (1 - 1e-5) <= float(T[away].min())
    np.testing.assert_allclose(dts, wind_run[1], rtol=1e-4)


def test_euler_hierarchy_three_steps_matches_reference():
    """A 2-level Euler blast ``NGHierarchy`` (HLL, Falle AV, one tracer;
    its corrector takes the fused wrappers and ``interface_flux_pair``'s
    Euler slabs), three steps against the JAX package: fields at 1e-9, dt
    at 1e-12."""
    layout = dict(ndim=2, shape=(16, 16), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                  bcs=(("outflow", "outflow"),) * 2)
    rcfg = pion_tpu.SimConfig(eqn="euler", solver="hll", ntracer=1,
                              cfl=0.3, ooa=2, av="falle", etav=0.1,
                              nlevels=2, tmax=1.0, gamma=1.4, **layout)
    glm = pion_tpu.SimConfig(eqn="glm", ntracer=1, nlevels=2, **layout)
    states = [s[[0, 1, 2, 3, 4, 9]] for s in level_states(glm, 2, 9)]
    ref = RefHierarchy(rcfg)
    ref.set_states([jnp.asarray(s) for s in states])
    fields = dict(dataclasses.asdict(rcfg), pallas="auto")
    hier = convert.hierarchy_from_reference(fields, states, device="cpu")
    assert hier.cfg0.kernels == "auto" and fused_sweep.supports(hier.cfg0)
    dts, rdts = [], []
    for _ in range(3):
        rdts.append(ref.step())
        dts.append(hier.step())
    np.testing.assert_allclose(dts, rdts, rtol=1e-12)
    np.testing.assert_allclose(hier.t, ref.t, rtol=1e-12)
    for lev in range(2):
        want = np.asarray(ref.P[lev])
        err = np.abs(hier.P[lev].numpy() - want) / scales(want)
        assert err.max() <= 1e-9, (lev, err.max())
