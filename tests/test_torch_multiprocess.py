"""A mesh of shards across processes (ROADMAP A20.5's multi-host item):
``torch.distributed`` on gloo, every rank a process with CPU shards.

The ranks are launched as subprocesses of this file with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in their environment
(the path torchrun takes), on a free port, each launch under a time limit
of its own that kills the whole group on expiry or as soon as one rank
fails.  Several cases share one launch; rank 0 writes each case's gathered
result, and every case must equal the one-process mesh of the same
factors (``make_mesh(cfg, devices=["cpu"] * 8)``), run here, bit for bit:
the states, ``t``, ``step_count`` and ``last_dt``.  The placement of the
shards is held against ``jax.experimental.mesh_utils`` on fake devices, and
the 2-rank blast against ``pion_tpu.Simulation`` on the eight virtual CPU
devices.  Seeded numpy inputs, float64.

Run as a worker: ``python tests/test_torch_multiprocess.py --worker
SHARDS_PER_RANK OUTDIR CASE ...`` under a launcher's environment."""
import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pion_tpu_torch import NGHierarchy, Simulation, SimConfig, WindSource
from pion_tpu_torch.constants import BX, K_B, MSUN, PG, RO, RSUN, YEAR
from pion_tpu_torch.ics import blast_wave
from pion_tpu_torch.microphysics import MPv3, MPv3Config
from pion_tpu_torch.parallel import Sharded, make_mesh, placement, shard_state
from pion_tpu_torch.parallel.mesh import _split_dcn
from pion_tpu_torch.physics import Physics
from pion_tpu_torch.raytracing import Source

torch.set_num_threads(1)

HERE = Path(__file__).resolve()
ROOT = HERE.parent.parent
LAUNCH_TIMEOUT_S = 240.0


# ---------------------------------------------------------------------------
# the cases: each builds its run on ``mesh_of(cfg)`` and returns what rank 0
# keeps (numpy arrays), the same whether one process holds every shard or
# several do
# ---------------------------------------------------------------------------

def blast_cfg(**kw) -> SimConfig:
    """A 3D GLM-MHD blast at 16^3 (HLLD, Falle AV, one tracer), float64."""
    base = dict(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                shape=(16,) * 3, xmin=(0.0,) * 3, xmax=(1.0,) * 3,
                bcs=(("outflow", "outflow"),) * 3, cfl=0.3, ooa=2,
                av="falle", etav=0.1, tmax=0.05, dtype="float64")
    base.update(kw)
    return SimConfig(**base)


def blast_state(cfg) -> np.ndarray:
    """The blast with seeded noise on the velocities, field and psi and a
    non-constant tracer."""
    rng = np.random.default_rng(31)
    P = np.asarray(blast_wave(cfg, B0=(0.1, 0.05, 0.0)), dtype=np.float64)
    P[2:5] += 0.05 * rng.standard_normal((3,) + cfg.shape)
    P[5:8] += 0.01 * rng.standard_normal((3,) + cfg.shape)
    P[9] = rng.random(cfg.shape)
    return P


def _result(sim) -> dict:
    """The run's gathered state(s) and clock on rank 0 (None elsewhere)."""
    levels = sim.P if isinstance(sim.P, list) else [sim.P]
    got = [p.gather(dst=0) for p in levels]
    if got[0] is None:
        return None
    return {"P": np.stack([g.numpy() for g in got]),
            "clock": np.array([sim.t, sim.step_count, sim.last_dt])}


def case_blast(mesh_of, out, halo="gspmd", chunk=1):
    cfg = blast_cfg(halo=halo)
    sim = Simulation(cfg, shard_state(torch.from_numpy(blast_state(cfg)),
                                      mesh_of(cfg)))
    sim.run(max_steps=4, chunk=chunk)
    return _result(sim)


def wind_bubble(mesh_of):
    """The photoionised Euler wind bubble (MPv3 ``mono``, a point source
    and a wind in cell n/2 - 1 of every axis, so a 2x2x2 mesh traces
    through B6's plain version; ``kernels="off"``: the plain ladder) on a
    16 x 16 x 32 grid: 8192 cells, so the ladder compacts its stiff cells
    (capacity 4096)."""
    n, L = 16, 3.0e18
    cfg = SimConfig(ndim=3, eqn="euler", solver="hll", ntracer=1,
                    shape=(n, n, 2 * n), xmin=(0.0,) * 3,
                    xmax=(L, L, 2 * L), bcs=(("outflow", "outflow"),) * 3,
                    cfl=0.3, ooa=2, av="falle", etav=0.1,
                    min_temperature=50.0, tmax=1.0e16, kernels="off")
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mono",
                     n_idot=1.0e48, min_temperature=50.0)
    ctr = (0.5 * L, 0.5 * L, L)
    phys = Physics(mp=MPv3(mpc), dt_limit=True,
                   sources=[Source(position=ctr, strength=1.0e48,
                                   effect="mono")],
                   wind_sources=[WindSource(
                       position=ctr, radius=2.5 * cfg.dx,
                       mdot=1.0e-7 * MSUN / YEAR, vinf=2.0e8, t_wind=3.0e4,
                       tracers=(1.0,))])
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = 10.0 * mpc.mean_mass_per_h
    P0[PG] = 11.0 * K_B * 100.0
    P0[cfg.eqn.nbase] = 1.0e-6
    return Simulation(cfg, shard_state(torch.from_numpy(P0), mesh_of(cfg)),
                      physics=phys)


def case_wind(mesh_of, out):
    from pion_tpu_torch.microphysics.mpv3 import MPv3 as _MPv3

    sets, solves = [], []
    ladder, stiff = _MPv3._ladder_sets, _MPv3._stiff_solve

    def spy_sets(use_eulers, mesh=None):
        got = ladder(use_eulers, mesh)
        sets.append(got is not None and any(
            g is not None and g[0] is not None for g in got))
        return got

    def spy_solve(self, bufs, *a, **k):
        solves.append(sum(int(b[0].numel()) for b in bufs))
        return stiff(self, bufs, *a, **k)

    _MPv3._ladder_sets = staticmethod(spy_sets)
    _MPv3._stiff_solve = spy_solve
    try:
        sim = wind_bubble(mesh_of)
        sim.run(max_steps=3)
    finally:
        _MPv3._ladder_sets, _MPv3._stiff_solve = staticmethod(ladder), stiff
    res = _result(sim)
    # whether any ladder of the run compacted its stiff cells (every rank
    # decides alike) and the ladder cells this rank stepped
    if res is not None:
        res["compacted"] = np.array(any(sets))
        res["ladder_cells"] = np.array(sum(solves))
    return res


def coupled_setup(n: int = 16):
    """The coupled flagship (tests/test_torch_coupled.py's set-up) at n^3 a
    level, two levels, float64, ``kernels="off"``: GLM-HLLD, MPv3
    ``mfion`` from a centred point source, a magnetised wind."""
    L = 6.0e18
    cfg = SimConfig(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                    shape=(n,) * 3, xmin=(0.0,) * 3, xmax=(L,) * 3,
                    bcs=(("outflow", "outflow"),) * 3, nlevels=2, cfl=0.3,
                    ooa=2, av="falle", etav=0.1, dtype="float64",
                    min_temperature=50.0, max_temperature=1.0e9,
                    tmax=1.0e16, kernels="off")
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mfion",
                     n_idot=1.0e48, tstar=3.75e4, rstar_cm=10.0 * RSUN,
                     min_temperature=50.0)
    ctr = (0.5 * L,) * 3

    def physics():
        return Physics(
            mp=MPv3(mpc), dt_limit=True,
            sources=[Source(position=ctr, strength=1.0e48, effect="mfion")],
            wind_sources=[WindSource(
                position=ctr, radius=6.0 * cfg.dx / 2,
                mdot=1.0e-6 * MSUN / YEAR, vinf=2.0e8, t_wind=3.0e4,
                b_star=10.0, tracers=(1.0,))])

    nH = 100.0
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 300.0
    P0[cfg.eqn.nbase] = 1.0e-6
    P0[BX] = 4.0e-6 / np.sqrt(4.0 * np.pi)
    return cfg, physics, [P0.copy(), P0.copy()]


def case_hierarchy(mesh_of, out):
    """2 steps of the coupled hierarchy, then its snapshot (written by rank
    0 alone) and a restart of it on the same mesh."""
    cfg, physics, states = coupled_setup()
    mesh = mesh_of(cfg)
    hier = NGHierarchy(cfg, 2, physics=physics(), mesh=mesh)
    hier.set_states(states)
    hier.run(max_steps=2)
    res = _result(hier)
    path = hier.save(os.path.join(out, f"hier_{_tag(mesh)}.snap"))
    back = NGHierarchy.restart(path, mesh=mesh)
    again = _result(back)
    if res is not None:
        res["snapshot"] = np.frombuffer(Path(path).read_bytes(), np.uint8)
        res["restarted"] = again["P"]
    return res


def case_save_restart(mesh_of, out):
    """2 steps of the blast, its snapshot (rank 0 writes), then a restart
    on the mesh and 2 more steps."""
    cfg = blast_cfg()
    mesh = mesh_of(cfg)
    sim = Simulation(cfg, shard_state(torch.from_numpy(blast_state(cfg)),
                                      mesh))
    sim.run(max_steps=2)
    path = sim.save(os.path.join(out, f"blast_{_tag(mesh)}.snap"))
    back = Simulation.restart(path, mesh=mesh).run(max_steps=4)
    res = _result(back)
    if res is not None:
        res["snapshot"] = np.frombuffer(Path(path).read_bytes(), np.uint8)
    return res


def case_transport(mesh_of, out):
    """The seam's own moves on a mesh of the blast's grid: ``gather`` to
    every rank and to rank 0, a ``region`` that crosses every block (edge
    cells repeated past the grid) to the ranks that ask for it,
    ``write_regions`` from the rank that holds each value, and the
    all-reduce of ``all_finite``."""
    from pion_tpu_torch.parallel import gather, region, write_regions

    cfg = blast_cfg()
    mesh = mesh_of(cfg)
    P = torch.from_numpy(blast_state(cfg))
    S = shard_state(P, mesh)
    whole = gather(S)
    box = [(-1, 9), (3, 14), (7, 18)]
    got = region(S, box, dst=[0])
    vals = [torch.full((10, 4, 4, 4), float(k), dtype=torch.float64)
            for k in range(3)]
    boxes = [((6, 10), (6, 10), (6, 10)), ((0, 4), (12, 16), (0, 4)),
             ((12, 16), (0, 4), (14, 18))]
    src = mesh.process_ranks[-1]
    W = write_regions(S, [(b, v if mesh.rank == src else None, src)
                          for b, v in zip(boxes[:2], vals[:2])]
                      + [(boxes[2][:2] + ((12, 16),), vals[2])])
    Wg = gather(W, dst=0)
    finite = S.all_finite()
    if mesh.rank != 0:
        return None
    return {"whole": whole.numpy(), "region": got.numpy(),
            "written": Wg.numpy(), "finite": np.array(finite)}


def case_mesh(mesh_of, out):
    """What a process learns of a mesh of several processes: its shards'
    owners (``placement``'s), its own shards and devices, the visible
    devices of every process (``mesh_requested``), no CUDA graph for a
    chunk, and a ``make_mesh`` whose ranks bring unequal counts raising on
    every rank."""
    from pion_tpu_torch import graphs
    from pion_tpu_torch.parallel import comm, mesh_requested, visible_devices

    cfg = blast_cfg(mesh="on")
    mesh = mesh_of(cfg)
    S = shard_state(torch.from_numpy(blast_state(cfg)), mesh)
    rec = {"ranks": mesh.ranks.copy(), "local": np.array(mesh.local),
           "held": np.array([b is not None for b in S.blocks]),
           "visible": np.array(len(visible_devices())),
           "requested": np.array(mesh_requested(cfg)),
           "graph": np.array(graphs.on_one_card(S))}
    if mesh.distributed:
        try:
            make_mesh(cfg, devices=["cpu"] * (1 + (comm.rank() == 0)))
            raised = False
        except ValueError:
            raised = True
        raised = comm.all_reduce_ints([raised], "min")[0]
        rec["unequal_raises"] = np.array(bool(raised))
    return rec if comm.rank() == 0 else None


def _tag(mesh) -> str:
    return "procs" if mesh.distributed else "one"


CASES = {
    "blast": case_blast,
    "blast_explicit": lambda m, o: case_blast(m, o, halo="explicit"),
    "blast_chunk": lambda m, o: case_blast(m, o, chunk=2),
    "save_restart": case_save_restart,
    "wind": case_wind,
    "hierarchy": case_hierarchy,
    "transport": case_transport,
    "mesh": case_mesh,
}


# ---------------------------------------------------------------------------
# the worker and the launcher
# ---------------------------------------------------------------------------

def _worker(argv) -> int:
    """Run the cases on a mesh of ``SHARDS_PER_RANK`` CPU shards a rank,
    under the launcher's group; with ``--one``, on the one-process 2x2x2
    mesh, no group.  Rank 0 writes each case's result to OUTDIR."""
    from pion_tpu_torch.parallel import comm

    one = argv[0] == "--one"
    if one:
        argv = argv[1:]
    per_rank, out, cases = int(argv[0]), argv[1], argv[2:]
    if not one:
        comm.init_distributed(device="cpu", timeout_s=LAUNCH_TIMEOUT_S)
    try:
        def mesh_of(cfg):
            return make_mesh(cfg, devices=["cpu"] * per_rank)

        for case in cases:
            res = CASES[case](mesh_of, out)
            if comm.rank() == 0:
                np.savez(os.path.join(out, f"{case}.npz"), **res)
    finally:
        comm.destroy()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(groups, timeout: float = LAUNCH_TIMEOUT_S):
    """Run ``groups`` at once, each ``(world, argv, out)``: ``world`` ranks
    of ``python <this file> argv`` (``argv`` starting with ``-m``: of
    ``python -m ...``) with a launcher's environment on a free port (world
    1: none), their output in ``out``.  Waits for all, and kills every
    process as soon as one fails or the time runs out.  Returns each
    group's ranks' output."""
    procs, logs = [], []
    for world, argv, out in groups:
        out.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get(
                "PYTHONPATH", "").split(os.pathsep) if p]))
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            env.pop(k, None)
        if world > 1:
            env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(_free_port()))
        cmd = [sys.executable] + (list(argv) if argv[0] == "-m"
                                  else [str(HERE)] + list(argv))
        for r in range(world):
            log = open(out / f"rank{r}.log", "w+")
            logs.append((out, r, log))
            renv = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if world > 1 \
                else env
            procs.append(subprocess.Popen(cmd, env=renv, cwd=out, stdout=log,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"process {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
            else:
                time.sleep(0.05)
        bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"process {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    texts = {}
    for out, r, log in logs:
        log.seek(0)
        texts.setdefault(str(out), []).append(log.read())
        log.close()
    if failed:
        raise AssertionError(f"{failed}:\n" + "\n".join(
            f"--- {out} rank {r}\n{t[-4000:]}" for out, ts in texts.items()
            for r, t in enumerate(ts)))
    return [texts[str(out)] for _, _, out in groups]


def run_cases(tmp_path_factory, name, launches, cases):
    """``cases`` on each mesh of ``launches`` (``(world, shards a rank)``)
    and on the one-process mesh, all at once; the results by mesh
    (``"WxS"``, or ``"one"``) and case."""
    groups, keys = [], []
    for world, per_rank in launches:
        out = tmp_path_factory.mktemp(f"{name}_{world}x{per_rank}")
        groups.append((world, ["--worker", str(per_rank), str(out)] + cases,
                       out))
        keys.append(f"{world}x{per_rank}")
    out = tmp_path_factory.mktemp(f"{name}_one")
    groups.append((1, ["--worker", "--one", "8", str(out)] + cases, out))
    keys.append("one")
    launch(groups)
    got = {}
    for key, (_, _, out) in zip(keys, groups):
        for case in cases:
            with np.load(out / f"{case}.npz") as f:
                got[(key, case)] = dict(f)
    return got


@pytest.fixture(scope="module")
def blasts(tmp_path_factory):
    """The blast cases and the seam's moves on 2 ranks of 4 shards and 4
    ranks of 2, and on the one-process mesh."""
    return run_cases(tmp_path_factory, "blast", [(2, 4), (4, 2)],
                     ["blast", "blast_explicit", "blast_chunk",
                      "save_restart", "transport", "mesh"])


@pytest.fixture(scope="module")
def wind(tmp_path_factory):
    return run_cases(tmp_path_factory, "wind", [(2, 4)], ["wind"])


@pytest.fixture(scope="module")
def hierarchy(tmp_path_factory):
    return run_cases(tmp_path_factory, "hier", [(2, 4)], ["hierarchy"])


def _same(got: dict, want: dict, keys=("P", "clock")):
    for k in keys:
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), (
            k, float(np.abs(got[k] - want[k]).max()))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

class _FakeDevice:
    """A device as ``mesh_utils`` reads it: an id and its process."""

    def __init__(self, i, proc):
        self.id = i
        self.process_index = proc
        self.slice_index = proc
        self.platform = "cpu"
        self.device_kind = "cpu"


@pytest.mark.parametrize("factors,world", [
    ((2, 2, 2), 2), ((2, 2, 2), 4), ((2, 2, 2), 8), ((4, 2, 1), 2),
    ((2, 4), 4), ((1, 2, 4), 2), ((4, 2, 2), 8)])
def test_placement_matches_hybrid_device_mesh(factors, world):
    """:func:`placement` (each shard's rank and local device) is the layout
    of ``create_hybrid_device_mesh(ici, dcn)`` on fake devices, ``count`` a
    process in rank-major order, as the JAX package's ``make_mesh`` calls
    it with ``_split_dcn``'s split."""
    from jax.experimental import mesh_utils

    n = int(np.prod(factors))
    count = n // world
    devs = [_FakeDevice(i, i // count) for i in range(n)]
    dcn, ici = _split_dcn(factors, world)
    want = mesh_utils.create_hybrid_device_mesh(ici, dcn, devices=devs)
    owner, local = placement(factors, [count] * world)
    for c in np.ndindex(*factors):
        d = want[c]
        assert owner[c] == d.process_index, c
        assert local[c] == d.id - count * d.process_index, c


def test_placement_falls_back_to_a_reshape():
    """Where ``_split_dcn`` gives None (ranks that do not split the mesh:
    3 shards over 2 processes with 2 devices and 1), the JAX package
    reshapes its device list; :func:`placement` lays the devices out the
    same way, rank-major."""
    assert _split_dcn((3,), 2) is None
    assert _split_dcn((3, 2), 4) is None
    devs = [_FakeDevice(0, 0), _FakeDevice(1, 0), _FakeDevice(2, 1)]
    want = np.array(devs, dtype=object).reshape((3,))
    owner, local = placement((3,), [2, 1])
    assert [d.process_index for d in want] == list(owner)
    assert list(local) == [0, 1, 0]
    owner, local = placement((3, 2), [2, 2, 1, 1])
    assert owner.tolist() == [[0, 0], [1, 1], [2, 3]]
    assert local.tolist() == [[0, 1], [0, 1], [0, 0]]


@pytest.mark.parametrize("launch_name", ["2x4", "4x2"])
@pytest.mark.parametrize("case", ["blast", "blast_explicit"])
def test_blast_across_processes(blasts, launch_name, case):
    """The 16^3 GLM blast, 4 steps, on 2 ranks of 4 shards (the mesh split
    along z) and 4 ranks of 2 (dcn [2, 2, 1]: strips and corners cross
    processes on two axes), with the default exchange and
    ``halo="explicit"``: bit for bit the one-process 2x2x2 mesh."""
    _same(blasts[(launch_name, case)], blasts[("one", case)])


@pytest.mark.parametrize("launch_name", ["2x4", "4x2"])
def test_chunk_across_processes(blasts, launch_name):
    """``run(chunk=2)`` on 2 and 4 ranks (eager: a mesh of several
    processes records no graph) equals the one-process mesh's single
    steps."""
    _same(blasts[(launch_name, "blast_chunk")], blasts[("one", "blast")])


@pytest.mark.parametrize("launch_name", ["2x4", "4x2"])
def test_save_and_restart_across_processes(blasts, launch_name):
    """``save`` from 2 ranks (gathered to rank 0, written there) gives the
    same file as the one-process mesh's save, byte for byte; a restart on
    the 2 ranks and 2 more steps equal the one-process mesh's."""
    got = blasts[(launch_name, "save_restart")]
    want = blasts[("one", "save_restart")]
    assert np.array_equal(got["snapshot"], want["snapshot"])
    _same(got, want)


@pytest.mark.parametrize("launch_name", ["2x4", "4x2", "one"])
def test_transport_moves(blasts, launch_name):
    """``gather``, ``region`` (to rank 0, edge cells repeated past the
    grid), ``write_regions`` from the rank that holds each value, and
    ``all_finite`` across 2 processes, against the whole array."""
    got = blasts[(launch_name, "transport")]
    cfg = blast_cfg()
    P = blast_state(cfg)
    assert np.array_equal(got["whole"], P)
    idx = np.ix_(np.clip(np.arange(-1, 9), 0, 15), np.arange(3, 14),
                 np.clip(np.arange(7, 18), 0, 15))
    assert np.array_equal(got["region"], P[(slice(None),) + idx])
    W = P.copy()
    W[:, 6:10, 6:10, 6:10] = 0.0
    W[:, 0:4, 12:16, 0:4] = 1.0
    W[:, 12:16, 0:4, 12:16] = 2.0
    assert np.array_equal(got["written"], W)
    assert bool(got["finite"])


@pytest.mark.parametrize("launch_name,world", [("2x4", 2), ("4x2", 4)])
def test_mesh_across_processes(blasts, launch_name, world):
    """The mesh as rank 0 of 2 and 4 processes sees it: each shard's owner
    is ``placement``'s, rank 0 holds exactly its own blocks, ``mesh_requested``
    counts every process's device, a chunk is not recorded as a graph, and
    ranks that bring unequal device counts to ``make_mesh`` all raise."""
    got = blasts[(launch_name, "mesh")]
    owner, _ = placement((2, 2, 2), [8 // world] * world)
    assert np.array_equal(got["ranks"], owner)
    mine = np.flatnonzero(owner.reshape(-1) == 0)
    assert np.array_equal(got["local"], mine)
    assert np.array_equal(np.flatnonzero(got["held"]), mine)
    assert int(got["visible"]) == world and bool(got["requested"])
    assert not bool(got["graph"])
    assert bool(got["unequal_raises"])
    one = blasts[("one", "mesh")]
    assert np.array_equal(one["ranks"], np.zeros((2, 2, 2), dtype=int))
    assert bool(one["held"].all()) and "unequal_raises" not in one


def test_wind_across_processes(wind):
    """The photoionised wind bubble on 2 ranks, 3 steps: B6's plain path
    with its planes across processes, the plain ladder with compaction on
    (the counts and the stiffness summed and maxed over the processes, the
    grid's last cell copied on the rank that owns it) and the Newton test
    reduced every iteration: bit for bit the one-process mesh."""
    got, want = wind[("2x4", "wind")], wind[("one", "wind")]
    assert bool(got["compacted"]) and bool(want["compacted"])
    assert int(got["ladder_cells"]) > 0
    _same(got, want)
    assert float(got["P"][0, 5].max()) > 0.5            # ionised


def test_hierarchy_across_processes(hierarchy):
    """The coupled hierarchy, 2 x 16^3, on 2 ranks, 2 steps (the exchange,
    the parent's window, the restriction and BC89 across processes, B6 on
    both levels, the plain ladder): bit for bit the one-process mesh, and
    its snapshot and a restart of it equal the one-process mesh's."""
    got, want = hierarchy[("2x4", "hierarchy")], hierarchy[("one",
                                                           "hierarchy")]
    _same(got, want)
    assert np.array_equal(got["snapshot"], want["snapshot"])
    assert np.array_equal(got["restarted"], want["P"])


BLAST_PARAMS = """\
# a 3D blast-wave run in the reference param dialect (tests/test_cli.py's)
ndim 3
coordinates cartesian
eqn euler
solver 8
OrderOfAccSpace 2
GAMMA 1.666666667
CFL 0.3
ArtificialViscosity 1
EtaViscosity 0.1
ics BlastWave
OutputFile blast
OutputFrequency 2
StartTime 0.0
FinishTime 0.02
ntracer 0
chem_code None
noise -1
NGridX 16
NGridY 16
NGridZ 16
Xmin 0.0
Ymin 0.0
Zmin 0.0
Xmax 1.0
Ymax 1.0
Zmax 1.0
BC_XN outflow
BC_XP outflow
BC_YN outflow
BC_YP outflow
BC_ZN outflow
BC_ZP outflow
RT_Nsources 0
WIND_NSRC 0
"""


def test_cli_across_processes(tmp_path):
    """``python -m pion_tpu_torch run p.txt mesh=on --device cpu`` under 2
    processes (the launcher's environment: the CLI starts the gloo group
    itself, one CPU device a rank, rank 0 alone writes): its snapshot holds
    the one-device CLI run's state bit for bit."""
    from pion_tpu_torch import cli
    from pion_tpu_torch.io.snapshot import load_snapshot_raw

    pf = tmp_path / "blast.txt"
    pf.write_text(BLAST_PARAMS + f"OutputPath {tmp_path / 'mp'}/\n")
    (tmp_path / "mp").mkdir()
    texts, = launch([(2, ["-m", "pion_tpu_torch", "run", str(pf),
                          "max_steps=4", "mesh=on", "--device", "cpu"],
                      tmp_path / "ranks")])
    assert "run: finished" in texts[0] and "run: finished" not in texts[1]
    pf1 = tmp_path / "blast1.txt"
    pf1.write_text(BLAST_PARAMS + f"OutputPath {tmp_path / 'one'}/\n")
    (tmp_path / "one").mkdir()
    cli.main(["run", str(pf1), "max_steps=4", "mesh=off", "--device",
              "cpu"])
    snaps = [sorted((tmp_path / d).glob("blast.*")) for d in ("mp", "one")]
    assert [p.name for p in snaps[0]] == [p.name for p in snaps[1]] == [
        f"blast.{k:08d}.snap" for k in (2, 4)]
    for a, b in zip(*snaps):
        ca, Pa, ta, sa, _ = load_snapshot_raw(str(a))
        cb, Pb, tb, sb, _ = load_snapshot_raw(str(b))
        assert (ta, sa) == (tb, sb) and a.name.endswith(f"{sa:08d}.snap")
        assert np.array_equal(Pa, Pb)


def test_blast_across_processes_matches_reference(blasts):
    """The 2-rank blast against ``pion_tpu.Simulation`` with ``mesh="on"``
    on the eight virtual CPU devices (the GSPMD-sharded step, Pallas off),
    4 steps, at tests/test_torch_sharded.py's sharded-vs-JAX tolerance
    (``test_nproc_invariance``: rtol 1e-12, atol 1e-13)."""
    import dataclasses as dc

    import jax.numpy as jnp
    import pion_tpu

    from pion_tpu_torch import convert

    cfg = blast_cfg()
    fields = convert.config_to_reference(cfg)
    fields.update(mesh="on", pallas="off")
    names = {f.name for f in dc.fields(pion_tpu.SimConfig)}
    rcfg = pion_tpu.SimConfig(**{k: v for k, v in fields.items()
                                 if k in names})
    ref = pion_tpu.Simulation(rcfg, jnp.asarray(blast_state(cfg)))
    assert ref.mesh is not None
    ref.run(max_steps=4)
    got = blasts[("2x4", "blast")]
    assert int(got["clock"][1]) == ref.step_count == 4
    np.testing.assert_allclose(got["clock"][0], ref.t, rtol=1e-12)
    np.testing.assert_allclose(got["P"][0], np.asarray(ref.P), rtol=1e-12,
                               atol=1e-13)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2:]))
