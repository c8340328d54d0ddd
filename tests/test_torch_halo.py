"""pion_tpu_torch.parallel.halo against pion_tpu.parallel.halo: the explicit
exchange and the sharded step (tests/test_halo.py's cases), the port's
sharded step held against the JAX package's ``make_sharded_step`` on its 8
virtual CPU devices and against the port's single-device run, at
rtol 1e-12, atol 1e-13."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.parallel.halo import make_sharded_step as ref_sharded_step
from pion_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pion_tpu.parallel.mesh import shard_state as ref_shard_state

from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.boundaries import apply_bcs
from pion_tpu_torch.parallel import Sharded, make_mesh, shard_state
from pion_tpu_torch.parallel.halo import (apply_bcs_sharded, local_config,
                                          make_sharded_step, supports)

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-13)


def _cfgs(bcs, shape=(32, 64), xmax=(1.0, 2.0), **kw):
    """tests/test_halo.py's config (the JAX package's, and the port's)."""
    rcfg = pion_tpu.SimConfig(
        ndim=len(shape), eqn="glm", solver="hlld", ntracer=1, shape=shape,
        xmin=(0.0,) * len(shape), xmax=xmax, bcs=bcs, cfl=0.3, ooa=2,
        av="falle", etav=0.1, tmax=0.03, **kw)
    return rcfg, convert.config_from_reference(dataclasses.asdict(rcfg))


def _noisy(P, seed):
    """The blast with seeded noise in every variable and a tracer that is
    not constant (the plain blast's zero velocities and tracer would hide
    a misplaced ghost)."""
    rng = np.random.default_rng(seed)
    P = P * (1.0 + 0.01 * rng.standard_normal(P.shape))
    P[2:5] += 0.01 * rng.standard_normal(P[2:5].shape)     # velocities
    P[-1] = rng.uniform(0.0, 1.0, P.shape[1:])
    return P


def _three_runs(bcs, steps, seed, shape=(32, 64), xmax=(1.0, 2.0),
                B0=(0.1, 0.05, 0.0), center=None):
    """The JAX package's sharded step, the port's sharded step and the
    port's single-device run from one seeded state, with the host dt loop of
    tests/test_halo.py (growth limit, no cap)."""
    rcfg, cfg = _cfgs(bcs, shape, xmax)
    kw = {} if center is None else {"center": center}
    P0 = _noisy(ref_blast_wave(rcfg, B0=B0, **kw), seed)
    rsim = pion_tpu.Simulation(rcfg, jnp.asarray(P0))
    radv, rdt = ref_sharded_step(rcfg, rsim.geom,
                                 ref_make_mesh(rcfg, n_devices=8))
    Pr = ref_shard_state(jnp.asarray(P0), ref_make_mesh(rcfg, n_devices=8),
                         rcfg)
    sim = Simulation(cfg, P0, device="cpu")
    mesh = make_mesh(cfg, devices=["cpu"] * 8)
    adv, calc_dt = make_sharded_step(cfg, sim.geom, mesh)
    Ps = shard_state(torch.from_numpy(P0), mesh, cfg)
    t = tr = 0.0
    last = last_r = 0.0
    for _ in range(steps):
        dt = float(calc_dt(Ps))
        dtr = float(rdt(Pr))
        if last:
            dt = min(dt, cfg.max_dt_growth * last)
            dtr = min(dtr, rcfg.max_dt_growth * last_r)
        Ps = adv(Ps, dt, t)
        Pr = radv(Pr, dtr, tr)
        t, tr, last, last_r = t + dt, tr + dtr, dt, dtr
        sim.step()
    assert isinstance(Ps, Sharded)
    assert abs(t - sim.t) <= 1e-12 * sim.t and abs(t - tr) <= 1e-12 * tr
    return np.asarray(Pr), Ps.gather().numpy(), sim.P.numpy()


@pytest.mark.parametrize("bcs", [
    (("outflow", "outflow"), ("periodic", "periodic")),
    (("reflecting", "reflecting"), ("reflecting", "reflecting")),
    (("oneway_out", "outflow"), ("outflow", "periodic"))])
def test_exchange_equals_whole_grid_padding(bcs):
    """Every shard's padded block is the whole grid's padding, sliced:
    outflow, periodic (round the ring), reflecting and one-way faces, edges
    and corners included, on meshes of 8, 4 and 2 shards."""
    _, cfg = _cfgs(bcs)
    P = torch.from_numpy(_noisy(np.ones((cfg.nvar,) + cfg.shape), 5))
    full = apply_bcs(P, cfg)
    ng = cfg.ng
    for n in (8, 4, 2):
        mesh = make_mesh(cfg, devices=["cpu"] * n)
        pads = apply_bcs_sharded(shard_state(P, mesh, cfg),
                                 local_config(cfg, mesh))
        for blk, r in zip(pads, mesh.ranges(cfg.shape)):
            sl = (slice(None),) + tuple(slice(lo, hi + 2 * ng)
                                        for lo, hi in r)
            assert torch.equal(blk, full[sl]), (n, r)


def test_sharded_step_matches_serial():
    """tests/test_halo.py::test_sharded_step_matches_serial: 8 steps of the
    2D GLM blast with outflow/periodic faces."""
    bcs = (("outflow", "outflow"), ("periodic", "periodic"))
    ref, got, one = _three_runs(bcs, 8, seed=11)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, one, **TOL)


def test_sharded_reflecting_walls():
    """tests/test_halo.py::test_sharded_reflecting_walls: 6 steps, an
    off-centre blast between reflecting walls."""
    bcs = (("reflecting", "reflecting"), ("reflecting", "reflecting"))
    ref, got, one = _three_runs(bcs, 6, seed=12, B0=(0.05, 0.0, 0.0),
                                center=(0.3, 0.5))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, one, **TOL)


def test_sharded_step_3d():
    """A 16^3 GLM blast on a 2x2x2 mesh, outflow on z, periodic on y,
    reflecting on x: 4 steps."""
    bcs = (("outflow", "outflow"), ("periodic", "periodic"),
           ("reflecting", "reflecting"))
    ref, got, one = _three_runs(bcs, 4, seed=13, shape=(16, 16, 16),
                                xmax=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, one, **TOL)


def test_simulation_halo_explicit_wired():
    """tests/test_halo.py::test_simulation_halo_explicit_wired:
    ``halo="explicit"`` routes ``Simulation.run`` through the sharded step
    (here over a sharded state of 8 CPU shards) and matches the JAX
    package's run and the port's single-device run."""
    bcs = (("outflow", "outflow"), ("periodic", "periodic"))
    rcfg, cfg = _cfgs(bcs)
    P0 = _noisy(ref_blast_wave(rcfg, B0=(0.1, 0.05, 0.0)), 14)
    ref = pion_tpu.Simulation(rcfg.with_(halo="explicit"), jnp.asarray(P0))
    ref.run(max_steps=6)
    one = Simulation(cfg, P0, device="cpu").run(max_steps=6)
    cfg_e = cfg.with_(halo="explicit")
    mesh = make_mesh(cfg_e, devices=["cpu"] * 8)
    sim = Simulation(cfg_e, shard_state(torch.from_numpy(P0), mesh))
    assert sim.mesh is mesh and isinstance(sim.P, Sharded)
    sim.run(max_steps=6)
    assert sim.step_count == ref.step_count == 6
    assert abs(sim.t - ref.t) < 1e-12 * ref.t and sim.t == one.t
    np.testing.assert_allclose(sim.P.gather().numpy(), np.asarray(ref.P),
                               **TOL)
    np.testing.assert_allclose(sim.P.gather().numpy(), one.P.numpy(), **TOL)


def test_simulation_halo_explicit_guards():
    """The JAX package's three guards raise instead of degrading:
    physics, a BC whose ghosts are not local edge data, a grid that is not
    Cartesian."""
    from pion_tpu_torch.physics import Physics
    from pion_tpu_torch.winds import WindSource

    bcs = (("outflow", "outflow"), ("periodic", "periodic"))
    rcfg, cfg = _cfgs(bcs)
    P0 = ref_blast_wave(rcfg, B0=(0.1, 0.05, 0.0))
    cfg_e = cfg.with_(halo="explicit")
    phys = Physics(wind_sources=[WindSource(position=(0.5, 0.5),
                                            radius=0.1, mdot=1e18,
                                            vinf=2e8)])
    with pytest.raises(NotImplementedError, match="pure dynamics"):
        Simulation(cfg_e, P0, physics=phys, device="cpu")
    fixed = cfg_e.with_(bcs=(("inflow", "outflow"), bcs[1]))
    assert not supports(fixed) and supports(cfg_e)
    with pytest.raises(NotImplementedError, match="local-data"):
        Simulation(fixed, P0, device="cpu")
    cyl = cfg_e.with_(coords="cylindrical",
                      bcs=(("axisymmetric", "outflow"), bcs[1]))
    with pytest.raises(NotImplementedError, match="Cartesian"):
        Simulation(cyl, P0, device="cpu")


def test_cli_halo_param():
    """``halo explicit`` in a parameter file reaches the port's config."""
    from pion_tpu_torch.io.params import config_from_params

    cfg = config_from_params({"ndim": "2", "NGridX": "32", "NGridY": "32",
                              "eqn": "euler", "halo": "explicit"})
    assert cfg.halo == "explicit"
