"""Nested-grid hierarchies on a mesh of shards (ROADMAP A20.4), the CLI's
``mesh on``, and faces that are not local edge data and axisymmetric grids
on a mesh (A20.5's first item), on the CPU: the port's mesh is
``make_mesh(cfg, devices=["cpu"] * k)`` (its CLI's, the visible-device list
patched to eight CPU devices), the JAX package's the eight virtual devices
of ``tests/conftest.py``.  Each sharded run of the port is held to its
one-device run bit for bit, and to the JAX package: its sharded run where
its own tests compile one (tests/test_ng_sharded.py), its one-device run
elsewhere.  Seeded numpy inputs, float64."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pion_tpu
from pion_tpu import cli as ref_cli
from pion_tpu.constants import BX as REF_BX
from pion_tpu.ics.blast import blast_wave as ref_blast_wave
from pion_tpu.io.snapshot import load_snapshot_raw as ref_load
from pion_tpu.microphysics import MPv3 as RefMPv3
from pion_tpu.ng import NGHierarchy as RefHierarchy
from pion_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pion_tpu.parallel.mesh import shard_state as ref_shard_state
from pion_tpu.physics import Physics as RefPhysics

from pion_tpu_torch import NGHierarchy, Simulation, cli, convert
from pion_tpu_torch.constants import K_B, PG, RO
from pion_tpu_torch.io.snapshot import load_snapshot_raw
from pion_tpu_torch.microphysics import MPv3, MPv3Config
from pion_tpu_torch.parallel import (Sharded, gather, make_mesh, mesh, region,
                                     shard_state, write_regions)
from pion_tpu_torch.physics import Physics
from pion_tpu_torch.raytracing import Source

import test_torch_coupled as coupled
from test_torch_cli import DMR, _write
from test_torch_cylindrical import VX, cyl_config, noisy_state, wind_bubble
from test_torch_ng import level_states, ref_cfg
from test_torch_params import JET

torch.set_num_threads(1)


def _cpu_mesh(cfg, k):
    return make_mesh(cfg, devices=["cpu"] * k)


def _blast_states(rcfg, hier):
    """tests/test_ng_sharded.py's states: a blast on every level about its
    centre, the field along x."""
    out = []
    for c in hier.cfgs:
        P = ref_blast_wave(c, rho0=1.0, p0=0.1, p_in=10.0, r_in=0.12,
                           center=tuple(0.5 * (a + b)
                                        for a, b in zip(c.xmin, c.xmax)))
        P[REF_BX] = 0.2
        out.append(P)
    return out


def _glm_blast(shape, nlevels=2, kernels="off"):
    nd = len(shape)
    return pion_tpu.SimConfig(
        ndim=nd, eqn="glm", solver="hlld", shape=shape, xmin=(0.0,) * nd,
        xmax=tuple(n / shape[-1] for n in shape),
        bcs=(("outflow", "outflow"),) * nd, cfl=0.3, ooa=2, av="falle",
        etav=0.1, nlevels=nlevels, pallas=kernels)


def _pair(rcfg, states, k, physics=None, **kw):
    """The port's hierarchy of ``rcfg`` from ``states`` on one device and
    on ``k`` CPU shards (``physics``: a function making each run's)."""
    fields = dataclasses.asdict(rcfg)
    cfg = convert.config_from_reference(fields)
    one = convert.hierarchy_from_reference(
        fields, states, physics=physics and physics(), device="cpu", **kw)
    sh = convert.hierarchy_from_reference(
        fields, states, physics=physics and physics(),
        mesh=_cpu_mesh(cfg, k), **kw)
    assert all(isinstance(p, Sharded) for p in sh.P)
    return one, sh


def _equal(one, sh):
    """Every level of the sharded hierarchy bit for bit the one-device
    one's, and the same clock."""
    assert sh.t == one.t and sh.step_count == one.step_count
    for l, (a, b) in enumerate(zip(one.P, sh.P)):
        a, b = gather(a), gather(b)
        assert torch.equal(b, a), (l, float((b - a).abs().max()))


def test_regions_across_blocks():
    """``region`` assembles any box from the blocks that overlap it, edge
    cells repeated past the grid (numpy's clipped indices), and
    ``write_regions`` writes boxes into the blocks they overlap, leaving
    the others the same tensors: (48, 32) on 6 shards, boxes that straddle
    blocks and reach past the grid."""
    cfg = convert.config_from_reference(dataclasses.asdict(
        _glm_blast((48, 32))))
    S_mesh = _cpu_mesh(cfg, 6)
    P = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 48, 32)))
    S = shard_state(P, S_mesh)
    for box in (((-2, 5), (3, 30)), ((10, 40), (-1, 33)), ((15, 17), (0, 32)),
                ((47, 50), (31, 34))):
        idx = [np.clip(np.arange(lo, hi), 0, n - 1)
               for (lo, hi), n in zip(box, (48, 32))]
        assert torch.equal(region(S, box), P[:, idx[0]][:, :, idx[1]]), box
    v = torch.ones(3, 20, 6, dtype=P.dtype)
    W = write_regions(S, [(((12, 32), (10, 16)), v)])
    want = P.clone()
    want[:, 12:32, 10:16] = v
    assert torch.equal(W.gather(), want)
    assert sum(a is b for a, b in zip(S.blocks, W.blocks)) == 4
    assert torch.equal(S.gather(), P)


def test_glm_blast_eight_shards_matches_reference_sharded():
    """tests/test_ng_sharded.py's 2-level GLM blast (32^2) on 8 shards,
    ``decompose`` (4, 2), so that child and parent block indices differ,
    4 steps by the JAX one-device run's dt: the JAX package's sharded run
    at its own test's 1e-12 / 1e-13, the port's one-device run bit for
    bit."""
    assert len(jax.devices()) >= 8, "conftest forces an 8-device CPU mesh"
    rcfg = _glm_blast((32, 32))
    ref = RefHierarchy(rcfg)
    states = _blast_states(rcfg, ref)
    ref.set_states([ref_shard_state(jnp.asarray(s), ref_make_mesh(rcfg),
                                    rcfg) for s in states])
    one, sh = _pair(rcfg, states, 8)
    assert sh.mesh.factors == (4, 2)
    for _ in range(4):
        dt = one.compute_dt()
        assert sh.compute_dt() == dt
        for h in (ref, one, sh):
            h.step(dt)
    _equal(one, sh)
    for l in range(2):
        np.testing.assert_allclose(sh.P[l].gather().numpy(),
                                   np.asarray(ref.P[l]), rtol=1e-12,
                                   atol=1e-13, err_msg=f"level {l}")


@pytest.mark.parametrize("kernels", ["auto", "off"])
def test_uneven_mesh_bit_for_bit(kernels):
    """(48, 32) on 6 shards, factors (3, 2): a child block's window
    straddles two parent blocks.  ``auto`` takes the fused sweep's plain
    versions and the corrector's face planes from slabs, ``off`` the plain
    sweep's faces; 3 steps, each dt the hierarchy's own."""
    rcfg = _glm_blast((48, 32), kernels=kernels)
    states = _blast_states(rcfg, RefHierarchy(rcfg))
    one, sh = _pair(rcfg, states, 6)
    assert sh.mesh.factors == (3, 2)
    for _ in range(3):
        assert sh.step() == one.step()
    _equal(one, sh)


def test_glm_blast_3d_two_by_two_by_two():
    """The 2-level GLM blast in 3D, 16^3 a level on 2x2x2 shards: 2 steps
    bit for bit the one-device run."""
    rcfg = _glm_blast((16, 16, 16))
    states = _blast_states(rcfg, RefHierarchy(rcfg))
    one, sh = _pair(rcfg, states, 8)
    assert sh.mesh.factors == (2, 2, 2)
    for _ in range(2):
        assert sh.step() == one.step()
    _equal(one, sh)


@pytest.mark.parametrize("layout", ["2d-corner", "3d-offcentre"])
def test_fine_faces_on_the_domain_on_a_mesh(layout):
    """tests/test_torch_ng.py's nests whose fine level meets the domain:
    a reflecting face and a frozen INFLOW face (its strip sliced to each
    block), a one-way face and a nest at a quarter; 2 steps bit for bit."""
    rcfg = ref_cfg(layout)
    states = level_states(rcfg, 2, 3)
    one, sh = _pair(rcfg, states, 4)
    for _ in range(2):
        assert sh.step() == one.step()
    _equal(one, sh)


def test_coupled_hierarchy_on_a_mesh():
    """The coupled flagship (tests/test_torch_coupled.py's set-up at 16^3
    a level: MPv3 mfion, a centred point source, a magnetised wind) on
    2x2x2 shards, 2 steps of dt 1e3 s (ROADMAP C4): the source's columns
    through the sharded trace on both levels, the plain ladder over every
    block.  Against the port's one-device run 1e-12 of each variable's
    scale (it comes out bit for bit), against the JAX package's
    one-device hierarchy 1e-9 (its own tests hold its sharded run to it)."""
    coupled_n, coupled.N = coupled.N, 16
    try:
        rcfg, mpc, src, wind, states = coupled.reference_setup()
    finally:
        coupled.N = coupled_n
    one, sh = _pair(rcfg, states, 8,
                    physics=lambda: coupled.port_physics(mpc, src, wind))
    tr = sh.phys[1].raytracer.point_tracers[0]
    assert tr.src_idx == (7, 7, 7) and sh.mesh.factors == (2, 2, 2)
    ref = RefHierarchy(rcfg, 2, physics=RefPhysics(
        mp=RefMPv3(mpc), sources=[src], wind_sources=[wind], dt_limit=True))
    ref.set_states([jnp.asarray(s) for s in states])
    for _ in range(2):
        for h in (ref, one, sh):
            h.step(1.0e3)
    for l in range(2):
        a, b = one.P[l].numpy(), sh.P[l].gather().numpy()
        want = np.asarray(ref.P[l])
        sc = coupled.field_scales(want, one.geoms[l].dx / (1.0e3 / 2 ** l))
        for v in range(rcfg.nvar):
            assert np.abs(b[v] - a[v]).max() <= 1e-12 * sc[v], (l, v)
            assert np.abs(b[v] - want[v]).max() <= 1e-9 * sc[v], (l, v)
    assert sh.P[1].gather()[rcfg.eqn.nbase].max() > 0.5   # ionised


def test_source_at_infinity_on_a_mesh():
    """A hierarchy lit by a source at infinity (rays along +axis 0): the
    child's upstream column offsets come from the parent's tau plane at
    the child's face, assembled from the blocks that hold it, and each
    child block takes its part; the dt from each level's chemistry limit.
    2D Euler, MPv3 mono, 2 steps on 4 shards bit for bit the one-device
    run; the nest's first row is lit through the parent's columns in front
    of it (a tenth of the parent's first row's ionisation and less) and
    shades its last."""
    L = 3.0e18
    rcfg = pion_tpu.SimConfig(
        ndim=2, eqn="euler", solver="hll", ntracer=1, shape=(16, 16),
        xmin=(0.0, 0.0), xmax=(L, L), bcs=(("outflow", "outflow"),) * 2,
        nlevels=2, cfl=0.3, ooa=2, av="falle", etav=0.1,
        min_temperature=50.0, max_temperature=1.0e9, tmax=1.0e16)
    mpc = MPv3Config(tracer_slot=5, ion_src="mono", n_idot=1.0e47,
                     min_temperature=50.0)
    P0 = np.zeros((rcfg.nvar,) + rcfg.shape)
    P0[RO] = mpc.mean_mass_per_h
    P0[PG] = 1.1 * K_B * 300.0
    P0[5] = 1.0e-6

    def physics():
        return Physics(mp=MPv3(mpc), dt_limit=True, sources=[Source(
            at_infinity=True, axis=0, sign=1, strength=1.0e12,
            effect="mono")])

    one, sh = _pair(rcfg, [P0, P0], 4, physics=physics)
    assert sh.mesh.factors == (2, 2)
    for _ in range(2):
        assert sh.step() == one.step()
    _equal(one, sh)
    x0, x1 = (sh.P[l].gather()[5] for l in range(2))
    assert float(x1[0].max()) < 0.5 * float(x0[0].min())
    assert float(x1[0].min()) > 10.0 * float(x1[-1].max())


def test_snapshots_restart_across_packages_and_onto_the_mesh(tmp_path):
    """A sharded hierarchy writes its gathered levels: the snapshot
    restarts in the JAX package with the state bit for bit; a JAX snapshot
    restarts on the port's mesh; 2 more steps from it equal the
    uninterrupted sharded run bit for bit."""
    rcfg = _glm_blast((32, 32))
    states = _blast_states(rcfg, RefHierarchy(rcfg))
    one, sh = _pair(rcfg, states, 8)
    for _ in range(2):
        sh.step()
    path = sh.save(str(tmp_path / "sharded"))
    ref = RefHierarchy.restart(path)
    assert ref.step_count == 2 and ref.t == sh.t
    for l in range(2):
        assert np.array_equal(np.asarray(ref.P[l]), sh.P[l].gather().numpy())
    rpath = ref.save(str(tmp_path / "ref"))
    again = NGHierarchy.restart(rpath, mesh=sh.mesh)
    assert again.mesh is sh.mesh and isinstance(again.P[1], Sharded)
    for h in (sh, again):
        h.step()
        h.step()
    _equal(sh, again)


def test_cli_mesh_on_runs_a_hierarchy_on_eight_devices(tmp_path,
                                                       monkeypatch):
    """A 2-level parameter file with ``mesh on``, the visible devices
    patched to eight CPU devices: the run is sharded, its snapshot is the
    one-device run's bit for bit and the JAX CLI's (``mesh on``, its eight
    devices) to 1e-12, and with ``chunk 2`` (a chunk of two steps, then
    one step) bit for bit the run without it; a restart with ``mesh on``
    re-shards the levels and continues as the one-device restart does."""
    monkeypatch.setattr(mesh, "visible_devices", lambda: [torch.device(
        "cpu")] * 8)
    chunks = []
    body = NGHierarchy._chunk
    monkeypatch.setattr(NGHierarchy, "_chunk", lambda self, *a: chunks.append(
        a[-1]) or body(self, *a))
    text = _ng_blast_text()
    runs = {}
    for who, extra in (("one", []), ("mesh", ["mesh=on"]),
                       ("chunk", ["mesh=on", "chunk=2"])):
        pf, d = _write(tmp_path, text, who)
        runs[who] = cli.run_main([pf, "max_steps=3", *extra,
                                  "--device", "cpu"])
    chunked = runs.pop("chunk")
    assert runs["mesh"].mesh is not None and runs["one"].mesh is None
    assert runs["mesh"].mesh.size == chunked.mesh.size == 8
    assert chunks == [2] and chunked.step_count == 3
    rpf, _ = _write(tmp_path, text, "ref")
    ref = ref_cli.run_main([rpf, "max_steps=3", "mesh=on"])
    snaps = {w: load_snapshot_raw(_snap(r, 3))[1] for w, r in runs.items()}
    assert np.array_equal(snaps["mesh"], snaps["one"])
    assert np.array_equal(load_snapshot_raw(_snap(chunked, 3))[1],
                          snaps["mesh"])
    assert chunked.t == runs["mesh"].t
    np.testing.assert_allclose(snaps["mesh"], ref_load(_snap(ref, 3))[1],
                               rtol=1e-12, atol=1e-13)
    again = {w: cli.run_main([_snap(r, 3), "max_steps=5",
                              f"mesh={'on' if w == 'mesh' else 'off'}",
                              "--device", "cpu"])
             for w, r in runs.items()}
    assert all(isinstance(p, Sharded) for p in again["mesh"].P)
    assert again["mesh"].step_count == 5
    _equal(again["one"], again["mesh"])


def _snap(run, step):
    """The snapshot a CLI run wrote at ``step``."""
    import glob

    (path,) = glob.glob(f"{run.outfile}.{step:08d}*")
    return path


def _ng_blast_text():
    """A 2-level 2D blast in the reference's dialect (tests/test_cli.py's
    blast with ``grid_nlevels 2``), its own ``OutputPath``."""
    from test_cli import PARAMS

    return PARAMS + "grid_nlevels 2\n"


JET_AXI = dict(JET, coordinates="cylindrical", BC_YN="axisymmetric",
               NGridX="32", NGridY="16", Xmax="2.0", Ymax="1.0")


@pytest.mark.parametrize("case", ["dmr", "jet", "inflow"])
def test_non_local_faces_on_a_mesh(tmp_path, monkeypatch, case):
    """Faces that are not local edge data on 8 shards through the CLI
    (``mesh on``, the visible devices patched to eight CPU devices): the
    double Mach reflection (an INFLOW face, DMACH2's wedge and DMACH's
    moving shock, the blocks' own positions along the wall), the
    axisymmetric jet (the JET face's nozzle on blocks of R, the
    axisymmetric axis) and a blast with an INFLOW face and a fixed one.
    12 steps bit for bit the one-device run, and 1e-12 of each variable's
    scale from the JAX package's one-device run."""
    monkeypatch.setattr(mesh, "visible_devices", lambda: [torch.device(
        "cpu")] * 8)
    from test_cli import PARAMS

    text = {"dmr": DMR,
            "jet": "\n".join(f"{k} {v}" for k, v in JET_AXI.items())
            + "\nOutputPath {path}/\nOutputFile jet\n",
            "inflow": PARAMS.replace("BC_XN outflow", "BC_XN inflow")
            .replace("BC_YP outflow", "BC_YP fixed")}[case]
    runs = {}
    for who, extra in (("one", []), ("mesh", ["mesh=on"])):
        pf, _ = _write(tmp_path, text, who)
        runs[who] = cli.run_main([pf, "max_steps=12", "log_freq=0", *extra,
                                  "--device", "cpu"])
    assert isinstance(runs["mesh"].P, Sharded)
    assert runs["mesh"].mesh.factors == {"inflow": (4, 2)}.get(case, (2, 4))
    rpf, _ = _write(tmp_path, text, "ref")
    ref = ref_cli.run_main([rpf, "max_steps=12", "log_freq=0"])
    got, one = runs["mesh"].P.gather().numpy(), runs["one"].P.numpy()
    assert runs["mesh"].t == runs["one"].t
    assert np.array_equal(got, one)
    want = np.asarray(ref.P)
    assert runs["mesh"].t == pytest.approx(ref.t, rel=1e-12, abs=0.0)
    scale = np.maximum(np.abs(want).reshape(want.shape[0], -1).max(axis=1),
                       1e-300)
    for v in range(want.shape[0]):
        assert np.abs(got[v] - want[v]).max() <= 1e-12 * scale[v], v


def test_axisymmetric_blast_on_a_mesh():
    """tests/test_torch_cylindrical.py's axisymmetric GLM-MHD blast on 8
    shards, the radial metric the whole grid's sliced to each block
    (``grid.block_geometry``; the radial branch of B1/B2's plain versions
    with each block's slice of the geometry pack): 5 steps bit for bit the
    one-device run."""
    rcfg = cyl_config("glm", "hlld", shape=(16, 32))
    P = noisy_state(rcfg, 13)
    cfg = convert.config_from_reference(dataclasses.asdict(rcfg))
    one = Simulation(cfg, P, device="cpu").run(max_steps=5)
    sim = Simulation(cfg, P, mesh=_cpu_mesh(cfg, 8)).run(max_steps=5)
    assert sim.mesh.factors == (2, 4)
    assert sim.t == one.t and torch.equal(sim.P.gather(), one.P)


def test_cylindrical_wind_hierarchy_on_a_mesh():
    """tests/test_torch_cylindrical.py's 3-level Wind2D-class hierarchy
    (Euler + HLL, a wind on the axis, the ambient streaming along z) on 4
    shards: the glue weighs by each block's slice of the cylindrical
    volumes and face areas; 2 steps bit for bit the one-device run."""
    rcfg, src, _, P0 = wind_bubble(eqn="euler", n=32)
    rcfg = dataclasses.replace(rcfg, nlevels=3, ng_centre=(0.0, 0.0))
    P0[VX] = -25.0e5

    def physics():
        return convert.physics_from_reference(
            None, dt_limit=0, wind_sources=[dataclasses.asdict(src)])

    one, sh = _pair(rcfg, [P0] * 3, 4, physics=physics)
    for _ in range(2):
        assert sh.step() == one.step()
    _equal(one, sh)


def test_what_a_mesh_still_refuses():
    """``run(chunk=k)`` on a sharded hierarchy runs (ROADMAP A20.5), bit
    for bit the one-device run stepped singly; levels that are not all
    sharded over one mesh are refused, naming them."""
    rcfg = _glm_blast((16, 16))
    states = _blast_states(rcfg, RefHierarchy(rcfg))
    one, sh = _pair(rcfg, states, 4)
    sh.run(max_steps=4, chunk=2)
    one.run(max_steps=4)
    assert sh.step_count == 4
    _equal(one, sh)
    cfg = sh.cfg0
    other = _cpu_mesh(cfg, 4)
    with pytest.raises(ValueError, match="levels 1"):
        NGHierarchy(cfg, device="cpu").set_states(
            [sh.P[0], shard_state(sh.P[1].gather(), other)])
    with pytest.raises(ValueError, match="levels 1"):
        NGHierarchy(cfg, device="cpu").set_states([sh.P[0], one.P[1]])
