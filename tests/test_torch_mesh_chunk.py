"""``run(chunk=k)`` on a mesh of shards (ROADMAP A20.5): ``Simulation`` and
``NGHierarchy`` on a sharded state take k steps at a time through
``multi_step`` (on the CPU eagerly: the CUDA graph is recorded only where
every shard lies on one card), and each chunked run equals the same mesh
stepped singly bit for bit; an evolving source's parameters are taken once
a chunk, as on one device and in the JAX package.  The port's mesh is
``make_mesh(cfg, devices=["cpu"] * 8)``, the JAX package's the eight
virtual devices of ``tests/conftest.py``.  Seeded numpy inputs, float64."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import MSUN, RSUN, YEAR
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.raytracing import Source as RefSource
from pion_tpu.raytracing import StarEvolution as RefStarEvolution
from pion_tpu.winds import WindSource as RefWindSource

from pion_tpu_torch import Simulation, convert, graphs
from pion_tpu_torch.constants import K_B, PG, RO
from pion_tpu_torch.parallel import Sharded, make_mesh, shard_state

import test_torch_coupled as coupled

torch.set_num_threads(1)


def _same_run(a, b):
    """Two sharded runs (one grid or a hierarchy) that must agree bit for
    bit: every level gathered, the clock, the step count, the last dt."""
    assert a.step_count == b.step_count
    assert a.t == b.t and a.last_dt == b.last_dt
    Pa = a.P if isinstance(a.P, list) else [a.P]
    Pb = b.P if isinstance(b.P, list) else [b.P]
    assert all(isinstance(x, Sharded) for x in Pa + Pb)
    assert all(torch.equal(x.gather(), y.gather()) for x, y in zip(Pa, Pb))


def _mesh8(cfg):
    return make_mesh(cfg, devices=["cpu"] * 8)


def _blast_cfg(**kw):
    """A 3D GLM-MHD blast at 16^3 (HLLD, Falle AV, one tracer), float64."""
    base = dict(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                shape=(16,) * 3, xmin=(0.0,) * 3, xmax=(1.0,) * 3,
                bcs=(("outflow", "outflow"),) * 3, cfl=0.3, ooa=2,
                av="falle", etav=0.1, tmax=0.05, dtype="float64")
    base.update(kw)
    return pion_tpu.SimConfig(**base)


def _blast_state(rcfg):
    """The blast with seeded noise on the velocities, field and psi and a
    non-constant tracer."""
    rng = np.random.default_rng(31)
    P = ref_blast_wave(rcfg, B0=(0.1, 0.05, 0.0))
    P[2:5] += 0.05 * rng.standard_normal((3,) + rcfg.shape)
    P[5:8] += 0.01 * rng.standard_normal((3,) + rcfg.shape)
    P[9] = rng.random(rcfg.shape)
    return P


def _sharded_blast(rcfg, P):
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    return Simulation(cfg, shard_state(torch.from_numpy(P), _mesh8(cfg)))


def _wind_bubble(sharded: bool, evolution=None):
    """tests/test_torch_sharded.py's photoionised wind bubble at 16^3
    (Euler + HLL, MPv3 ``mono``, a point source and a wind in cell 7 of
    every axis, so the sharded run traces through B6's plain version; the
    plain ladder), on 2x2x2 CPU shards or one device; ``evolution``: the
    source's evolution table."""
    n, L = 16, 3.0e18
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="euler", solver="hll", ntracer=1, shape=(n,) * 3,
        xmin=(0.0,) * 3, xmax=(L,) * 3, bcs=(("outflow", "outflow"),) * 3,
        cfl=0.3, ooa=2, av="falle", etav=0.1, min_temperature=50.0,
        tmax=1.0e16, pallas="off")
    mpc = RefMPv3Config(tracer_slot=rcfg.eqn.nbase, ion_src="mono",
                        n_idot=1.0e48, min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    src = RefSource(position=ctr, strength=1.0e48, effect="mono",
                    evolution=evolution)
    wind = RefWindSource(position=ctr, radius=2.5 * rcfg.dx,
                         mdot=1.0e-7 * MSUN / YEAR, vinf=2.0e8, t_wind=3.0e4,
                         tracers=(1.0,))
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = 10.0 * mpc.mean_mass_per_h
    P0[PG] = 11.0 * K_B * 100.0
    P0[rcfg.eqn.nbase] = 1.0e-6
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(src)], dt_limit=True,
        wind_sources=[dataclasses.asdict(wind)])
    if not sharded:
        return Simulation(cfg, P0, physics=phys, device="cpu")
    return Simulation(cfg, shard_state(torch.from_numpy(P0), _mesh8(cfg)),
                      physics=phys)


def test_graphs_take_a_sharded_state():
    """``graphs._flatten`` / ``_rebuild`` / ``layout`` of a nesting that
    holds a sharded state: its blocks in the mesh's order, rebuilt on the
    same mesh and shape; the layout names the mesh's factors and each
    block's shape and dtype.  CPU blocks are not one card's."""
    rcfg = _blast_cfg()
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    mesh = _mesh8(cfg)
    S = shard_state(torch.from_numpy(_blast_state(rcfg)), mesh)
    clock = (torch.zeros((), dtype=torch.float64),) * 2
    tree = ((S, S.map(lambda b: 2.0 * b)), clock,
            {"0": {"rel": torch.ones(())}})
    leaves = graphs._flatten(tree, [])
    assert len(leaves) == 2 * 8 + 2 + 1
    assert all(x is b for x, b in zip(leaves, S.blocks))
    back = graphs._rebuild(tree, iter([x.clone() for x in leaves]))
    for got, want in zip(back[0], tree[0]):
        assert isinstance(got, Sharded) and got.mesh is mesh
        assert got.shape == want.shape
        assert all(torch.equal(a, b) and a is not b
                   for a, b in zip(got.blocks, want.blocks))
    assert torch.equal(back[2]["0"]["rel"], torch.ones(()))
    lay = graphs.layout(tree)
    assert lay[0][0] == ("sharded", (2, 2, 2),
                         (((10, 8, 8, 8), torch.float64),) * 8)
    assert lay == graphs.layout(back)
    assert not graphs.on_one_card(tree)


@pytest.mark.parametrize("stop", ["max_steps", "tmax"])
def test_blast_chunk_on_a_mesh(stop):
    """The 16^3 GLM blast on 2x2x2 shards, ``chunk=4``: 8 steps, or a
    ``tmax`` that lands inside the second chunk; bit for bit the mesh
    stepped singly (the states, ``t``, ``step_count``, ``last_dt``)."""
    rcfg = _blast_cfg()
    P = _blast_state(rcfg)
    kw = {"max_steps": 8}
    if stop == "tmax":
        probe = _sharded_blast(rcfg, P).run(max_steps=6)
        kw = {"tmax": probe.t + 0.5 * probe.last_dt}
    got = _sharded_blast(rcfg, P).run(chunk=4, **kw)
    one = _sharded_blast(rcfg, P).run(**kw)
    assert isinstance(got.P, Sharded) and got.mesh.factors == (2, 2, 2)
    assert got.step_count == (8 if stop == "max_steps" else 7)
    _same_run(got, one)


def test_wind_bubble_chunk_on_a_mesh():
    """The photoionised wind bubble on 2x2x2 shards (B6's plain version,
    the plain ladder over every block, the wind per block): its first step
    alone (the first-step wind cap), then a chunk of 2; bit for bit the
    mesh stepped singly."""
    got = _wind_bubble(True).run(max_steps=3, chunk=2)
    one = _wind_bubble(True).run(max_steps=3)
    assert got.step_count == 3
    _same_run(got, one)
    assert float(got.P.gather()[5].max()) > 0.5          # ionised


def test_coupled_hierarchy_chunk_on_a_mesh():
    """The coupled flagship (tests/test_torch_coupled.py's set-up at 16^3 a
    level: MPv3 mfion, a centred point source, a magnetised wind) on 2x2x2
    shards, 3 steps: the first alone (the wind cap), then a chunk of 2,
    its levels selected block by block; bit for bit the mesh hierarchy
    stepped singly."""
    coupled_n, coupled.N = coupled.N, 16
    try:
        rcfg, mpc, src, wind, states = coupled.reference_setup()
    finally:
        coupled.N = coupled_n
    fields = dataclasses.asdict(rcfg)
    mesh = _mesh8(convert.config_from_reference(fields))

    def make():
        return convert.hierarchy_from_reference(
            fields, states, physics=coupled.port_physics(mpc, src, wind),
            mesh=mesh)

    got = make().run(max_steps=3, chunk=2)
    one = make().run(max_steps=3)
    assert got.step_count == 3
    _same_run(got, one)


def test_evolving_source_chunk_on_a_mesh():
    """A source whose luminosity doubles over 1e5 s (the wind bubble's
    ``mono`` source, its strength following L), 3 steps with ``chunk=2``
    (the first alone, then a chunk that starts from a brighter source): on
    the mesh the source's parameters go into the chunk as device tensors,
    taken once a chunk, as on one device.  Against the chunked one-device
    run at tests/test_torch_sharded.py's sharded-vs-one-device tolerance
    (1e-12 of each variable's scale, dt 1e-12)."""
    evo = RefStarEvolution(
        time=np.array([0.0, 1.0e5]),
        log_L=np.log10(np.array([1.0e48, 2.0e48])),
        log_T=np.log10(np.array([4.0e4, 4.0e4])),
        log_R=np.log10(np.array([10.0, 10.0]) * RSUN))
    sh = _wind_bubble(True, evo)
    one = _wind_bubble(False, evo)
    sh.step()
    rel = sh.physics.update_sources(sh.t)["0"]["rel"]
    assert rel > 1.01, rel                  # the chunk's source has moved
    sh.run(max_steps=3, chunk=2)
    one.run(max_steps=3, chunk=2)
    assert sh.step_count == one.step_count == 3
    np.testing.assert_allclose(sh.t, one.t, rtol=1e-12)
    np.testing.assert_allclose(sh.last_dt, one.last_dt, rtol=1e-12)
    a, b = sh.P.gather().numpy(), one.P.numpy()
    for v in range(a.shape[0]):
        scale = max(np.abs(b[v]).max(), 1e-300)
        assert np.abs(a[v] - b[v]).max() <= 1e-12 * scale, v


def test_explicit_halo_steps_singly_under_chunk(monkeypatch):
    """``halo="explicit"`` keeps the JAX package's rule: its step functions
    have no ``multi_step`` (pion_tpu/sim.py:115-128), so ``run(chunk=k)``
    takes single steps, and equals the run without ``chunk``."""
    rcfg = _blast_cfg()
    P = _blast_state(rcfg)
    cfg = convert.config_from_reference(
        dataclasses.asdict(rcfg)).with_(halo="explicit")
    sims = [Simulation(cfg, shard_state(torch.from_numpy(P), _mesh8(cfg)))
            for _ in range(2)]
    got, one = sims
    assert got.fns.multi_step is None and isinstance(got.P, Sharded)
    steps = []
    step = got.fns.step
    got.fns = got.fns._replace(
        step=lambda *a, **k: steps.append(1) or step(*a, **k))
    got.run(max_steps=4, chunk=2)
    one.run(max_steps=4)
    assert len(steps) == 4
    _same_run(got, one)


def test_mesh_chunk_matches_reference():
    """``pion_tpu.Simulation`` with ``mesh="on"`` on the eight virtual CPU
    devices (the GSPMD-sharded ``multi_step``, Pallas off) runs
    ``run(chunk=4)`` for 8 steps of the 16^3 GLM blast; the port's chunked
    run on 2x2x2 CPU shards agrees at tests/test_torch_sharded.py's
    sharded-vs-JAX tolerance (``test_nproc_invariance``: rtol 1e-12, atol
    1e-13), with the same step count."""
    rcfg = _blast_cfg(mesh="on", pallas="off")
    P = _blast_state(rcfg)
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P))
    assert ref.mesh is not None
    ref.run(max_steps=8, chunk=4)
    got = _sharded_blast(rcfg, P).run(max_steps=8, chunk=4)
    assert got.step_count == ref.step_count == 8
    np.testing.assert_allclose(got.t, ref.t, rtol=1e-12)
    np.testing.assert_allclose(got.P.gather().numpy(), np.asarray(ref.P),
                               rtol=1e-12, atol=1e-13)
