"""Sharded runs with physics (ROADMAP A20.3, one level) and the sharded
octant trace B6, against the JAX package on the CPU (its 8 virtual devices,
the port's 8 CPU shards), from seeded numpy inputs: tests/test_sharding.py's
and tests/test_ng_sharded.py's runs, and tests/test_pallas_trace.py's
sharded trace."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu.constants import MSUN, YEAR
from pion_tpu.grid import make_geometry as ref_make_geometry
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.microphysics import MPv3Config as RefMPv3Config
from pion_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pion_tpu.physics import Physics as RefPhysics
from pion_tpu.raytracing import Source as RefSource
from pion_tpu.raytracing.pallas_trace import (
    sharded_octant_trace as ref_sharded_trace,
    supports_sharded as ref_supports_sharded)
from pion_tpu.raytracing.tracer import PointSourceTracer as RefTracer
from pion_tpu.winds import WindSource as RefWindSource

from pion_tpu_torch import Simulation, convert
from pion_tpu_torch.constants import K_B, PG, RO
from pion_tpu_torch.parallel import Sharded, make_mesh, shard_state
from pion_tpu_torch.raytracing import fused_trace, sharded_trace

torch.set_num_threads(1)

TRACE_TOL = {torch.float32: 5e-6, torch.float64: 1e-12}


def _mesh8(cfg):
    return make_mesh(cfg, devices=["cpu"] * 8)


def test_nproc_invariance():
    """tests/test_sharding.py::test_nproc_invariance: the 2D GLM blast to
    tmax, the port sharded over 8 shards against the JAX run on one device
    and the port's own single-device run: 1e-12, the same step count."""
    rcfg = pion_tpu.SimConfig(
        ndim=2, eqn="glm", solver="hlld", shape=(64, 64), xmin=(0.0, 0.0),
        xmax=(1.0, 1.0), bcs=(("outflow", "outflow"), ("outflow", "outflow")),
        cfl=0.3, ooa=2, av="falle", etav=0.1, tmax=0.02)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    P0 = ref_blast_wave(rcfg, B0=(0.1, 0.0, 0.0))
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P0)).run()
    one = Simulation(cfg, P0, device="cpu").run()
    sim = Simulation(cfg, shard_state(torch.from_numpy(P0), _mesh8(cfg)))
    assert isinstance(sim.P, Sharded) and sim.mesh.factors == (4, 2)
    sim.run()
    assert sim.step_count == ref.step_count == one.step_count
    got = sim.P.gather().numpy()
    np.testing.assert_allclose(got, np.asarray(ref.P), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got, one.P.numpy(), rtol=1e-12, atol=1e-13)


def test_mpv3_point_source_sharded_invariance():
    """tests/test_ng_sharded.py::test_mpv3_point_source_sharded_invariance:
    MPv3 chemistry and a point source on a 2D grid (the gathered trace),
    three advances; the port with ``kernels="off"`` sharded over 8 shards
    against the JAX run on one device at 1e-12 of each variable's scale
    (the JAX test's own tolerance between its sharded and single runs)."""
    n, nH = 32, 100.0
    rcfg = pion_tpu.SimConfig(
        ndim=2, eqn="euler", ntracer=1, solver="hll", shape=(n, n),
        xmin=(0.0, 0.0), xmax=(3.0e18, 3.0e18),
        bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2, av="falle",
        etav=0.1, min_temperature=50.0, tmax=1.0e15, pallas="off")
    mpc = RefMPv3Config(tracer_slot=5, ion_src="mono", n_idot=1.0e47)
    src = RefSource(position=(1.5e18, 1.5e18), strength=1.0e47,
                    effect="mono")
    P = np.zeros((rcfg.nvar,) + rcfg.shape)
    P[RO] = nH * mpc.mean_mass_per_h
    P[PG] = 1.1 * nH * K_B * 500.0
    P[5] = 1.0e-6
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(P), physics=RefPhysics(
        mp=RefMPv3(mpc), sources=[src], dt_limit=False))
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(src)], dt_limit=False)
    sim = Simulation(cfg, shard_state(torch.from_numpy(P), _mesh8(cfg)),
                     physics=phys)
    for _ in range(3):
        dt = ref.compute_dt()
        ref.P = ref.fns.advance(ref.P, dt, ref.t)
        sim.P = sim.fns.advance(sim.P, dt, sim.t)
        ref.t += dt
        sim.t += dt
    a, b = np.asarray(ref.P), sim.P.gather().numpy()
    assert np.all(np.isfinite(b)) and a[5].max() > 0.1
    for v in range(cfg.nvar):
        np.testing.assert_allclose(
            b[v], a[v], rtol=1e-12,
            atol=1e-12 * max(np.abs(a[v]).max(), 1e-300),
            err_msg=f"variable {v}")


def _coupled(dtype, sharded, kernels="off"):
    """tests/test_sharding.py's coupled run at n = 16: Euler + HLL, MPv3
    ``mono``, a point source and a wind at the centre (the source cell
    n/2 - 1, so the port's sharded run takes B6's plain version);
    ``kernels``: the port's setting."""
    n, L = 16, 3.0e18
    rcfg = pion_tpu.SimConfig(
        ndim=3, eqn="euler", solver="hll", ntracer=1, shape=(n,) * 3,
        xmin=(0.0,) * 3, xmax=(L,) * 3, bcs=(("outflow", "outflow"),) * 3,
        cfl=0.3, ooa=2, av="falle", etav=0.1, dtype=dtype,
        min_temperature=50.0, tmax=1.0e16, mesh="off", pallas="off")
    mpc = RefMPv3Config(tracer_slot=rcfg.eqn.nbase, ion_src="mono",
                        n_idot=1.0e48, min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    src = RefSource(position=ctr, strength=1.0e48, effect="mono")
    wind = RefWindSource(position=ctr, radius=2.5 * rcfg.dx,
                         mdot=1.0e-7 * MSUN / YEAR, vinf=2.0e8, t_wind=3.0e4,
                         tracers=(1.0,))
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape, dtype=rcfg.np_dtype)
    P0[RO] = 10.0 * mpc.mean_mass_per_h
    P0[PG] = 11.0 * K_B * 100.0
    P0[rcfg.eqn.nbase] = 1.0e-6
    if sharded is None:
        return pion_tpu.Simulation(rcfg, jnp.asarray(P0), physics=RefPhysics(
            mp=RefMPv3(mpc), sources=[src], wind_sources=[wind],
            dt_limit=True))
    cfg = dataclasses.replace(
        convert.config_from_reference(dataclasses.asdict(rcfg)),
        kernels=kernels)
    phys = convert.physics_from_reference(
        dataclasses.asdict(mpc), [dataclasses.asdict(src)], dt_limit=True,
        wind_sources=[dataclasses.asdict(wind)])
    if not sharded:
        return Simulation(cfg, P0, physics=phys, device="cpu")
    return Simulation(cfg, shard_state(torch.from_numpy(P0), _mesh8(cfg)),
                      physics=phys)


def _steps(sim, n):
    return [sim.step() for _ in range(n)]


def test_coupled_sharded_run_float32():
    """tests/test_sharding.py::test_coupled_sharded_run_matches_single_device
    in float32, 4 steps, the port on 2x2x2 shards.  Each step the JAX run
    on one device (``mesh="off"``: its own test holds sharded = single)
    forms the dt, which the port's sharded and single-device runs must
    match to 2e-4 from their own states, and all three advance by it (as
    test_mpv3_point_source_sharded_invariance steps): every variable within
    2e-4 of its scale of the JAX run, and the sharded run within 2e-4 cell
    by cell of the single-device one (the JAX test's own check between its
    sharded and single runs).  Stepping by one dt keeps the packages' dt
    rounding out of the fields: the JAX package forms the float32 run's dt
    in float64, the port in float32 (ROADMAP C16)."""
    ref, sim = _coupled("float32", None), _coupled("float32", True)
    one = _coupled("float32", False)
    assert isinstance(sim.P, Sharded) and sim.mesh.factors == (2, 2, 2)
    for _ in range(4):
        dt = ref.compute_dt()
        np.testing.assert_allclose([sim.compute_dt(), one.compute_dt()],
                                   [dt, dt], rtol=2e-4)
        for s in (ref, sim, one):
            s.P = s.fns.advance(s.P, dt, s.t)
            s.t += dt
    a, b, c = np.asarray(ref.P), sim.P.gather().numpy(), one.P.numpy()
    assert b.dtype == np.float32 and np.all(np.isfinite(b))
    assert a[PG].max() > 10.0 * a[PG].min()       # the front has formed
    np.testing.assert_allclose(b, c, rtol=2e-4, atol=1e-30)
    for v in range(a.shape[0]):
        assert np.abs(b[v] - a[v]).max() <= 2e-4 * np.abs(a[v]).max(), v


def test_coupled_sharded_run_float64():
    """The same run in float64, 2 steps: against the JAX run the dt to
    1e-9 and the fields to 1e-7 of each variable's scale (as
    tests/test_torch_hii.py holds the H II run); against the port's
    single-device run 1e-12 (the same blocks of arithmetic; the plain
    ladder steps every shard's stiff cells with one Newton test, as one
    device does)."""
    ref = _coupled("float64", None)
    one, sim = _coupled("float64", False), _coupled("float64", True)
    rdts, dts, odts = _steps(ref, 2), _steps(sim, 2), _steps(one, 2)
    a, b, c = np.asarray(ref.P), sim.P.gather().numpy(), one.P.numpy()
    np.testing.assert_allclose(dts, rdts, rtol=1e-9)
    np.testing.assert_allclose(dts, odts, rtol=1e-12)
    for v in range(a.shape[0]):
        scale = max(np.abs(a[v]).max(), 1e-300)
        assert np.abs(b[v] - a[v]).max() <= 1e-7 * scale, v
        assert np.abs(b[v] - c[v]).max() <= 1e-12 * scale, v
    # the wind region holds the wind state on every shard that cuts it
    assert b[5].max() > 0.99


def test_sharded_dt_through_the_chemistry_kernels_plain_versions():
    """With ``kernels="auto"`` the chemistry's dt limit on a sharded state
    takes B4's wrapper once a block (its plain version for CPU blocks),
    each block given its slice of the whole grid's path lengths: the dt
    equals the single-device run's."""
    one = _coupled("float64", False, kernels="auto")
    sim = _coupled("float64", True, kernels="auto")
    assert sim.cfg.kernels == "auto" and isinstance(sim.P, Sharded)
    np.testing.assert_allclose(sim.compute_dt(), one.compute_dt(),
                               rtol=1e-12)


def _trace_case(dtype, seed=3):
    shape = (16, 16, 16)
    rcfg = pion_tpu.SimConfig(ndim=3, eqn="euler", solver="hll", shape=shape,
                              xmin=(0.0,) * 3, xmax=(1.0,) * 3,
                              bcs=(("outflow", "outflow"),) * 3,
                              dtype="float32")
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    tr = RefTracer(rcfg, ref_make_geometry(rcfg), (0.5, 0.5, 0.5))
    dtau = np.random.default_rng(seed).uniform(0.01, 0.5, shape)
    return rcfg, cfg, tr, dtau.astype(np.float32 if dtype == torch.float32
                                      else np.float64)


def test_sharded_trace_plain_matches_reference_interpret():
    """B6's plain version against the JAX package's
    ``sharded_octant_trace(..., interpret=True)`` on its 8 virtual devices,
    16^3 float32, the source in cell 7 of every axis: 5e-6 of max tau (as
    tests/test_pallas_trace.py holds the JAX trace)."""
    rcfg, cfg, tr, dtau = _trace_case(torch.float32)
    mesh_r = ref_make_mesh(rcfg, n_devices=8)
    assert tuple(tr.src_idx) == (7, 7, 7)
    assert ref_supports_sharded(rcfg.shape, tr.src_idx, mesh_r)
    dj = jax.device_put(jnp.asarray(dtau), jax.sharding.NamedSharding(
        mesh_r, jax.sharding.PartitionSpec("z", "y", "x")))
    ref = np.asarray(ref_sharded_trace(dj, mesh_r, tr.tau_min,
                                       interpret=True))
    mesh = _mesh8(cfg)
    S = shard_state(torch.from_numpy(dtau), mesh)
    before = (fused_trace.octant_trace.launches,
              sharded_trace.sharded_octant_trace.launches)
    col = sharded_trace.sharded_octant_trace_plain(S.blocks, mesh,
                                                   tr.tau_min)
    got = Sharded(col, mesh, dtau.shape).gather().numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() < TRACE_TOL[torch.float32] * ref.max()
    # the wrapper on CPU blocks takes the plain version and counts nothing
    wrapped = sharded_trace.sharded_octant_trace(S.blocks, mesh, tr.tau_min)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, col))
    assert (fused_trace.octant_trace.launches,
            sharded_trace.sharded_octant_trace.launches) == before


@pytest.mark.parametrize("seed", [3, 4])
def test_sharded_trace_plain_equals_whole_grid_float64(seed):
    """In float64 the sharded trace gives the whole grid's
    ``octant_trace_plain`` to 1e-12 of max tau (the same formula cell by
    cell, each octant traced from its own block)."""
    _, cfg, tr, dtau = _trace_case(torch.float64, seed)
    d = torch.from_numpy(dtau)
    want = fused_trace.octant_trace_plain(d, tr.src_idx, tr.tau_min)
    mesh = _mesh8(cfg)
    col = sharded_trace.sharded_octant_trace_plain(
        shard_state(d, mesh).blocks, mesh, tr.tau_min)
    got = Sharded(col, mesh, d.shape).gather()
    assert float((got - want).abs().max()) <= \
        TRACE_TOL[torch.float64] * float(want.max())


def test_supports_sharded_matches_reference_gate():
    """The port's gate equals the JAX gate wherever the JAX gate's float32
    and VMEM terms admit the case (here: every small grid)."""
    cases = [((16, 16, 16), (7, 7, 7)), ((16, 16, 16), (8, 7, 7)),
             ((16, 16, 16), (3, 7, 7)), ((8, 16, 16), (3, 7, 7)),
             ((16, 16, 32), (7, 7, 15)), ((16, 16, 32), (7, 7, 7)),
             ((14, 14, 14), (6, 6, 6)), ((16, 16), (7, 7)),
             ((8, 8, 64), (3, 3, 31))]
    n_true = 0
    for shape, src in cases:
        rcfg = pion_tpu.SimConfig(
            ndim=len(shape), shape=shape, xmin=(0.0,) * len(shape),
            xmax=tuple(float(n) for n in shape),
            bcs=(("outflow", "outflow"),) * len(shape))
        cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
        want = ref_supports_sharded(shape, src, ref_make_mesh(rcfg,
                                                              n_devices=8))
        got = sharded_trace.supports_sharded(shape, src, _mesh8(cfg))
        assert got == want, (shape, src)
        n_true += got
    assert n_true >= 3
