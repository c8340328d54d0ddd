"""pion_tpu_torch.parallel.mesh against pion_tpu.parallel.mesh: the mesh
factors, the multi-host split, the sharded state and the mesh gate, on the
CPU (the JAX package on the 8 virtual devices of tests/conftest.py, the
port on 8 shards of the CPU)."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

import pion_tpu
from pion_tpu.parallel import mesh as ref_mesh

from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.ics import blast_wave
from pion_tpu_torch.parallel import mesh as port_mesh
from pion_tpu_torch.parallel import Sharded, gather, make_mesh, shard_state

torch.set_num_threads(1)


def _cfg(shape=(8, 12, 16), **kw):
    rcfg = pion_tpu.SimConfig(
        ndim=len(shape), eqn="glm", solver="hlld", ntracer=1, shape=shape,
        xmin=(0.0,) * len(shape), xmax=tuple(float(n) for n in shape),
        bcs=(("outflow", "outflow"),) * len(shape), **kw)
    return rcfg, convert.config_from_reference(dataclasses.asdict(rcfg))


def test_decompose_matches_reference():
    """``tests/test_sharding.py::test_decompose``'s cases, then 50 seeded
    (devices, ndim, shape) triples: the same factors as the JAX package's."""
    assert port_mesh.decompose(8, 3, (64, 64, 64)) == (2, 2, 2)
    assert port_mesh.decompose(4, 2, (64, 64)) == (2, 2)
    assert port_mesh.decompose(1, 1, (64,)) == (1,)
    assert port_mesh.decompose(6, 2, (64, 32)) == (3, 2)
    rng = np.random.default_rng(2024)
    for _ in range(50):
        n = int(rng.integers(1, 65))
        nd = int(rng.integers(1, 4))
        shape = tuple(int(v) for v in rng.integers(4, 300, nd))
        got = port_mesh.decompose(n, nd, shape)
        assert got == ref_mesh.decompose(n, nd, shape), (n, nd, shape)
        assert int(np.prod(got)) == n


def test_split_dcn_matches_reference():
    rng = np.random.default_rng(7)
    for _ in range(40):
        factors = [int(v) for v in rng.choice([1, 2, 3, 4, 6, 8],
                                               int(rng.integers(1, 4)))]
        nproc = int(rng.choice([1, 2, 3, 4, 8, 16]))
        assert port_mesh._split_dcn(factors, nproc) == \
            ref_mesh._split_dcn(factors, nproc), (factors, nproc)


def test_mesh_layout_matches_reference():
    """A mesh of 8 over a 3D grid: the JAX package's factors and axis names,
    the devices as given (one device may stand for every shard)."""
    rcfg, cfg = _cfg()
    ref = ref_mesh.make_mesh(rcfg, n_devices=8)
    mesh = make_mesh(cfg, devices=["cpu"] * 8)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.shape == dict(ref.shape) == {"z": 2, "y": 2, "x": 2}
    assert mesh.size == 8 and all(d == torch.device("cpu")
                                  for d in mesh.devices.flat)
    assert mesh.neighbour(0, 2, -1) == 1 and mesh.neighbour(7, 0, 1) == 3
    two = make_mesh(_cfg((8, 16))[1], devices=["cpu"] * 6)
    assert two.factors == ref_mesh.decompose(6, 2, (8, 16)) == (2, 3)


@pytest.mark.parametrize("n,shape", [(8, (8, 12, 16)), (6, (8, 12, 18)),
                                     (4, (12, 16)), (2, (16,))])
def test_shard_state_and_gather_bit_for_bit(n, shape):
    """Each shard holds its own copy of its block, the JAX package's block
    of that shard; gathering gives the state back bit for bit."""
    rcfg, cfg = _cfg(shape)
    rng = np.random.default_rng(n)
    P = rng.standard_normal((cfg.nvar,) + cfg.shape)
    mesh = make_mesh(cfg, devices=["cpu"] * n)
    S = shard_state(torch.from_numpy(P), mesh, cfg)
    assert isinstance(S, Sharded) and S.shape == P.shape
    ref = ref_mesh.shard_state(jax.numpy.asarray(P),
                               ref_mesh.make_mesh(rcfg, n_devices=n), rcfg)
    for blk, rng_b in zip(S.blocks, S.ranges()):
        sl = (slice(None),) + tuple(slice(lo, hi) for lo, hi in rng_b)
        assert np.array_equal(blk.numpy(), P[sl])
        assert blk.is_contiguous()
    ref_blocks = sorted((tuple(s.start or 0 for s in sh.index[1:]),
                         np.asarray(sh.data)) for sh in ref.addressable_shards)
    port_blocks = sorted((tuple(lo for lo, _ in r), b.numpy())
                         for r, b in zip(S.ranges(), S.blocks))
    assert len(ref_blocks) == len(port_blocks) == n
    for (ra, a), (rb, b) in zip(ref_blocks, port_blocks):
        assert ra == rb and np.array_equal(a, b)
    G = gather(S)
    assert torch.equal(G, torch.from_numpy(P))
    G[0] += 1.0                       # the gathered state is a copy
    assert np.array_equal(S.blocks[0].numpy(),
                          P[(slice(None),) + tuple(
                              slice(lo, hi) for lo, hi in S.ranges()[0])])
    assert shard_state(S, mesh) is S
    with pytest.raises(ValueError, match="evenly"):
        shard_state(torch.zeros((1,) + cfg.shape[:-1]
                                + (cfg.shape[-1] + 1,)), mesh)


def test_conversion_shards_and_gathers():
    """``from_reference(mesh=...)`` shards on the way in (a sharded
    ``jax.Array`` arrives gathered through ``np.asarray``);
    ``to_reference`` gathers."""
    rcfg, cfg = _cfg()
    P = np.random.default_rng(3).standard_normal((cfg.nvar,) + cfg.shape)
    Pj = ref_mesh.shard_state(jax.numpy.asarray(P),
                              ref_mesh.make_mesh(rcfg, n_devices=8), rcfg)
    mesh = make_mesh(cfg, devices=["cpu"] * 8)
    cfg2, S, _ = convert.from_reference(dataclasses.asdict(rcfg), Pj,
                                        mesh=mesh)
    assert cfg2 == cfg and isinstance(S, Sharded) and S.mesh is mesh
    _, back, _ = convert.to_reference(cfg2, S)
    assert np.array_equal(back, P)


def test_mesh_requested_on_the_cpu():
    """One visible device (here none): no mode shards, as in the JAX
    package with one device; a mesh of the visible cards raises without
    one; ``mesh="on"`` runs the one device it is given."""
    assert not torch.cuda.is_available()
    _, cfg = _cfg()
    for mode in ("on", "auto", "off"):
        assert not port_mesh.mesh_requested(cfg.with_(mesh=mode))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(cfg)
    P = blast_wave(cfg)
    sim = Simulation(cfg.with_(mesh="on"), P, device="cpu")
    assert sim.mesh is None and isinstance(sim.P, torch.Tensor)


def test_sharded_entry_points_need_a_card_or_the_cpu():
    """A sharded run takes its devices from the caller or the visible
    cards, never silently from the CPU: ``halo="explicit"`` raises without
    a card and without ``device="cpu"``, and runs a mesh of the CPU with
    it; a state sharded over CPU shards runs on them, and with ``chunk``
    (single steps: ``halo="explicit"`` has no ``multi_step``) as without."""
    _, cfg = _cfg()
    cfg = cfg.with_(halo="explicit")
    P = blast_wave(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cfg, P)
    sim = Simulation(cfg, P, device="cpu")
    assert isinstance(sim.P, Sharded) and sim.mesh.size == 1
    mesh = make_mesh(cfg, devices=["cpu"] * 8)
    sim8 = Simulation(cfg, shard_state(torch.from_numpy(P), mesh))
    assert sim8.mesh is mesh and sim8.device == torch.device("cpu")
    sim.run(max_steps=2)
    sim8.run(max_steps=2)
    assert sim.t == sim8.t
    assert torch.equal(sim8.P.gather(), sim.P.gather())
    sim8.run(tmax=4.0, max_steps=4, chunk=2)
    sim.run(tmax=4.0, max_steps=4)
    assert sim8.step_count == 4 and sim8.t == sim.t
    assert torch.equal(sim8.P.gather(), sim.P.gather())


def test_sharded_run_snapshot_restarts_in_both_packages(tmp_path):
    """A sharded run writes its gathered state: the snapshot restarts in
    the JAX package, on one device of the port, and on the port's mesh,
    each with the state bit for bit."""
    rcfg, cfg = _cfg()
    P = blast_wave(cfg)
    mesh = make_mesh(cfg, devices=["cpu"] * 8)
    sim = Simulation(cfg, shard_state(torch.from_numpy(P), mesh))
    sim.run(max_steps=2)
    path = sim.save(str(tmp_path / "sharded"))
    want = sim.P.gather().numpy()
    ref = pion_tpu.Simulation.restart(path)
    assert ref.step_count == 2 and np.array_equal(np.asarray(ref.P), want)
    one = Simulation.restart(path, device="cpu")
    assert np.array_equal(one.P.numpy(), want) and one.t == sim.t
    again = Simulation.restart(path, mesh=mesh)
    assert isinstance(again.P, Sharded)
    assert np.array_equal(again.P.gather().numpy(), want)
