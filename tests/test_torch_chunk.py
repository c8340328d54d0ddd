"""Several steps in one dispatch: ``Simulation.run(chunk=k)`` and
``NGHierarchy.run(chunk=k)`` against the JAX package's chunked runs, and
against the port's own step-by-step runs bit for bit.  On the CPU the chunk
runs eagerly (the CUDA graph is recorded only on the card); what it computes
is the same body.  float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import RSUN
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.ng import NGHierarchy as RefHierarchy
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.raytracing import StarEvolution as RefStarEvolution

from pion_tpu_torch import Simulation, convert

from test_torch_coupled import field_scales, reference_setup
from test_torch_ng import level_states, ref_cfg as ng_ref_cfg

torch.set_num_threads(1)


def blast_cfg(**kw):
    """The JAX package's chunk test config (tests/test_multid.py:207-210):
    2D 32^2 GLM-MHD, HLLD, Falle AV, one tracer."""
    base = dict(ndim=2, eqn="glm", solver="hlld", ntracer=1,
                shape=(32, 32), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2,
                av="falle", etav=0.1, tmax=0.05, dtype="float64")
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def blast_state(rcfg):
    """The blast wave with seeded noise on velocities, field and psi and a
    non-constant tracer (the plain blast hides the tracer flux)."""
    rng = np.random.default_rng(21)
    P = ref_blast_wave(rcfg, B0=(0.1, 0.05, 0.0))
    P[2:5] += 0.05 * rng.standard_normal((3,) + rcfg.shape)
    P[5:8] += 0.01 * rng.standard_normal((3,) + rcfg.shape)
    P[9] = rng.random(rcfg.shape)
    return P


def port_sim(rcfg, P, **kw):
    cfg, Pt, _ = convert.from_reference(dataclasses.asdict(rcfg), P,
                                        device="cpu")
    return Simulation(cfg, Pt, device="cpu", **kw)


def assert_same_run(a, b):
    """Two runs of the port that must agree bit for bit."""
    assert a.step_count == b.step_count
    assert a.t == b.t and a.last_dt == b.last_dt
    Pa = a.P if isinstance(a.P, list) else [a.P]
    Pb = b.P if isinstance(b.P, list) else [b.P]
    assert all(torch.equal(x, y) for x, y in zip(Pa, Pb))


@pytest.mark.parametrize("stop", ["max_steps", "tmax"])
def test_simulation_chunk_matches_reference(stop):
    """``run(max_steps=12, chunk=4)``, and a run whose ``tmax`` lands inside
    a chunk of 8, against the JAX package's same runs (the 5-step dynamics
    tolerance, 1e-8) and against the port's step-by-step run, bit for bit:
    the same steps, the same clock, the same state."""
    rcfg = blast_cfg()
    P = blast_state(rcfg)
    run = (dict(max_steps=12, chunk=4) if stop == "max_steps"
           else dict(tmax=0.02, chunk=8))
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P)).run(**run)
    got = port_sim(rcfg, P).run(**run)
    one = port_sim(rcfg, P).run(**{k: v for k, v in run.items()
                                   if k != "chunk"})
    assert_same_run(got, one)
    assert got.step_count == ref.step_count
    if stop == "max_steps":
        assert got.step_count == 12
    else:
        # it stops on tmax, inside its second chunk
        assert 8 < got.step_count < 16 and got.t == pytest.approx(0.02,
                                                                  rel=1e-12)
    np.testing.assert_allclose(got.t, ref.t, rtol=1e-12)
    np.testing.assert_allclose(got.P.numpy(), np.asarray(ref.P), rtol=1e-8,
                               atol=1e-11)


class _Counted:
    """A ``multi_step`` that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("gate", ["opfreq_time", "callback", "log_freq",
                                  "max_steps"])
def test_chunk_gates_follow_reference(gate, tmp_path):
    """Where the JAX package steps one by one in spite of ``chunk``, the
    port does too, and takes the same number of chunks elsewhere: a timed
    output, a callback, a log cadence that is not a multiple of the chunk,
    and ``max_steps`` inside a chunk (the whole chunks, then single
    steps).  The run equals the step-by-step run bit for bit."""
    rcfg = blast_cfg(shape=(16, 16))
    P = blast_state(rcfg)
    kw, run = {}, dict(max_steps=6, chunk=4)
    if gate == "opfreq_time":
        kw = dict(opfreq_time=1.0e-3)
    elif gate == "log_freq":
        kw = dict(log_freq=3)
    elif gate == "callback":
        run["callback"] = lambda s: None

    def out(name):
        return dict(outfile=str(tmp_path / name)) if kw.get("opfreq_time") \
            else {}

    calls = []
    for make in (lambda: pion_tpu.Simulation(rcfg, jnp.asarray(P), **kw,
                                             **out("ref")),
                 lambda: port_sim(rcfg, P, **kw, **out("port"))):
        sim = make()
        counted = _Counted(sim.fns.multi_step)
        sim.fns = sim.fns._replace(multi_step=counted)
        sim.run(**run)
        assert sim.step_count == 6
        calls.append(counted.calls)
    assert calls[1] == calls[0] == (1 if gate == "max_steps" else 0)
    one = port_sim(rcfg, P, **kw, **out("one"))
    one.run(**{k: v for k, v in run.items() if k != "chunk"})
    assert_same_run(sim, one)


def test_hierarchy_chunk_matches_reference():
    """A 2-level GLM-MHD blast, 8 steps at chunk 4: against the JAX
    package's chunked run at the 3-step hierarchy tolerance (1e-9, dt
    1e-12), and against the port's step-by-step run bit for bit."""
    rcfg = ng_ref_cfg("2d-centred")
    states = level_states(rcfg, 2, 5)
    ref = RefHierarchy(rcfg)
    ref.set_states([jnp.asarray(s) for s in states])
    ref.run(max_steps=8, chunk=4)
    runs = []
    for chunk in (4, 1):
        hier = convert.hierarchy_from_reference(dataclasses.asdict(rcfg),
                                                states, device="cpu")
        runs.append(hier.run(max_steps=8, chunk=chunk))
    got, one = runs
    assert_same_run(got, one)
    assert got.step_count == ref.step_count == 8
    np.testing.assert_allclose(got.t, ref.t, rtol=1e-12)
    for l in range(2):
        np.testing.assert_allclose(got.P[l].numpy(), np.asarray(ref.P[l]),
                                   rtol=1e-9, atol=1e-12)


def test_coupled_hierarchy_chunk_matches_reference():
    """The coupled flagship at 12^3 a level (MPv3 + a point source + a
    magnetised wind), three steps at chunk 2: the first step alone (a run
    with winds takes it so, for the first-step wind cap), then one chunk.
    The source has an evolution table, hotter and larger than the module's
    star, that moves by less than 1 % over the run: its parameters go into
    the chunk on the device, once (as the JAX package takes them once a
    chunk).  Against the JAX package's chunked run at the coupled
    tolerances (dt 1e-9, fields 1e-7), and against the port's step-by-step
    run bit for bit."""
    rcfg, mpc, src, wind, states = reference_setup()
    evo = RefStarEvolution(
        time=np.array([0.0, 1.0e15]),
        log_L=np.log10(np.array([1.0e39, 1.002e39])),
        log_T=np.log10(np.array([4.2e4, 4.21e4])),
        log_R=np.log10(np.array([12.0, 12.02]) * RSUN))
    src = dataclasses.replace(src, evolution=evo)
    ref = RefHierarchy(rcfg, 2, physics=RefPhysics(
        mp=RefMPv3(mpc), sources=[src], wind_sources=[wind], dt_limit=True))
    ref.set_states([jnp.asarray(s) for s in states])
    ref.run(max_steps=3, chunk=2)
    runs = []
    for chunk in (2, 1):
        phys = convert.physics_from_reference(
            dataclasses.asdict(mpc), [dataclasses.asdict(src)],
            dt_limit=True, wind_sources=[dataclasses.asdict(wind)])
        hier = convert.hierarchy_from_reference(
            dataclasses.asdict(rcfg), states, physics=phys, device="cpu")
        runs.append(hier.run(max_steps=3, chunk=chunk))
    got, one = runs
    sp = got.physics.update_sources(got.t)
    assert sp is not None and abs(sp["0"]["rel"] - 1.0) > 0.01
    assert_same_run(got, one)
    assert got.step_count == ref.step_count == 3
    np.testing.assert_allclose(got.t, ref.t, rtol=1e-9)
    np.testing.assert_allclose(got.last_dt, ref.last_dt, rtol=1e-9)
    for l in range(2):
        want = np.asarray(ref.P[l])
        sc = field_scales(want, got.geoms[l].dx / (got.last_dt / 2 ** l))
        err = np.abs(got.P[l].numpy() - want).reshape(rcfg.nvar, -1).max(1)
        assert (err <= 1e-7 * sc).all(), (l, err / sc)
