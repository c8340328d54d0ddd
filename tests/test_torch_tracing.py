"""The port's spans and counters (``pion_tpu_torch.tracing``) on the CPU:
off they cost one check and change nothing; on, in either mode, a run is
bit for bit the run without them, every span of the step fires as often
as the step does its work, a span nested in another keeps its own work,
and the counters (the chemistry ladder's, the transport's, the graphs')
land in ``summary()``.  Small grids, float64, no JAX."""
import functools
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pion_tpu_torch import NGHierarchy, SimConfig, Simulation, WindSource
from pion_tpu_torch import graphs, tracing, utils
from pion_tpu_torch.constants import BX, K_B, MSUN, PG, RO, RSUN, YEAR
from pion_tpu_torch.ics import blast_wave
from pion_tpu_torch.microphysics import MPv3, MPv3Config
from pion_tpu_torch.microphysics import fused_mpv3
from pion_tpu_torch.physics import Physics
from pion_tpu_torch.raytracing import Source

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off."""
    tracing.disable()
    yield
    tracing.disable()


def blast_cfg(nlevels=1, **kw):
    base = dict(ndim=2, eqn="glm", solver="hlld", ntracer=1,
                shape=(16, 16), xmin=(0.0, 0.0), xmax=(1.0, 1.0),
                bcs=(("outflow", "outflow"),) * 2, cfl=0.3, ooa=2,
                av="falle", etav=0.1, tmax=1.0, dtype="float64",
                kernels="off", nlevels=nlevels)
    base.update(kw)
    return SimConfig(**base)


def noisy_blast(cfg, seed=3):
    rng = np.random.default_rng(seed)
    P = blast_wave(cfg, B0=(0.1, 0.05, 0.0))
    P[2:5] += 0.05 * rng.standard_normal((3,) + cfg.shape)
    P[cfg.eqn.nbase] = rng.random(cfg.shape)
    return P


def coupled(n=8, kernels="off"):
    """The coupled flagship at n^3 a level, two levels: GLM-HLLD, MPv3
    ``mfion`` from a centred point source, a magnetised wind."""
    L = 6.0e18
    cfg = SimConfig(ndim=3, eqn="glm", solver="hlld", ntracer=1,
                    shape=(n,) * 3, xmin=(0.0,) * 3, xmax=(L,) * 3,
                    bcs=(("outflow", "outflow"),) * 3, nlevels=2, cfl=0.3,
                    ooa=2, av="falle", etav=0.1, dtype="float64",
                    min_temperature=50.0, max_temperature=1.0e9,
                    tmax=1.0e16, kernels=kernels)
    mpc = MPv3Config(tracer_slot=cfg.eqn.nbase, ion_src="mfion",
                     n_idot=1.0e48, tstar=3.75e4, rstar_cm=10.0 * RSUN,
                     min_temperature=50.0)
    ctr = (0.5 * L,) * 3
    phys = Physics(
        mp=MPv3(mpc), dt_limit=True,
        sources=[Source(position=ctr, strength=1.0e48, effect="mfion")],
        wind_sources=[WindSource(
            position=ctr, radius=3.0 * cfg.dx / 2, mdot=1.0e-6 * MSUN / YEAR,
            vinf=2.0e8, t_wind=3.0e4, b_star=10.0, tracers=(1.0,))])
    nH = 100.0
    P0 = np.zeros((cfg.nvar,) + cfg.shape)
    P0[RO] = nH * mpc.mean_mass_per_h
    P0[PG] = 1.1 * nH * K_B * 300.0
    P0[cfg.eqn.nbase] = 1.0e-6
    P0[BX] = 4.0e-6 / np.sqrt(4.0 * np.pi)
    hier = NGHierarchy(cfg, physics=phys, device="cpu")
    hier.set_states([P0.copy(), P0.copy()])
    return hier


def make_run(kind):
    """A fresh run of ``kind``: a single grid, a 3-level hierarchy of the
    blast (2D), or the coupled 2-level hierarchy (3D, 8^3 a level)."""
    if kind == "grid":
        cfg = blast_cfg()
        return Simulation(cfg, noisy_blast(cfg), device="cpu")
    if kind == "hierarchy":
        cfg = blast_cfg(nlevels=3)
        P = noisy_blast(cfg)
        hier = NGHierarchy(cfg, device="cpu")
        hier.set_states([P.copy() for _ in range(3)])
        return hier
    return coupled()


def states(run):
    return list(run.P) if isinstance(run.P, list) else [run.P]


# steps of each kind: chunks of 2 (the coupled run's first step goes alone,
# for its wind)
STEPS = {"grid": 4, "hierarchy": 4, "coupled": 3}


def advance(run, kind):
    run.run(max_steps=STEPS[kind], chunk=2)
    return run


@pytest.mark.parametrize("kind", ["grid", "hierarchy"])
def test_off_is_one_shared_null_context(kind):
    """Off, ``span`` is the one shared null context whatever its name, and
    a run leaves the registry as it found it."""
    assert tracing.mode() is None and not tracing.eager()
    assert tracing.span("fill") is tracing.span("chem")
    assert tracing.span("run.chunk").__enter__() is None
    before = tracing.summary()
    advance(make_run(kind), kind)
    assert tracing.summary() == before


@pytest.mark.parametrize("kind,mode", [
    ("grid", "host"), ("grid", "device"), ("hierarchy", "host"),
    ("hierarchy", "device"), ("coupled", "device")])
def test_on_is_bit_for_bit_off(kind, mode):
    """A chunked run with tracing on, in either mode, equals the run with
    tracing off bit for bit: states, clock, steps.  (On the CPU both modes
    run the chunk's body eagerly; the coupled run takes the "device"
    mode's path.)"""
    off = advance(make_run(kind), kind)
    tracing.enable(mode)
    on = advance(make_run(kind), kind)
    tracing.disable()
    assert (on.t, on.step_count, on.last_dt) == (off.t, off.step_count,
                                                 off.last_dt)
    assert all(torch.equal(a, b) for a, b in zip(states(on), states(off)))


# each leaf span's calls a step of the 3-level 2D blast hierarchy with the
# kernels off: level l advances 2^l times a step (7 advances), each pads
# twice; the levels with a child (0, 1: 3 advances) restrict once and
# correct by BC89 once; the levels with a parent (1, 2: 6 advances)
# restrict their 2 x ndim boundary planes
HIERARCHY_CALLS = {"fill": 14, "glue.prolong": 12, "glue.bc89": 3,
                   "glue.restrict": 3 + 6 * 4, "sweep": 14, "update": 14,
                   "step.dt": 1, "step.select": 2}
GRID_CALLS = {"fill": 2, "sweep": 2, "update": 2, "step.dt": 1,
              "step.select": 2}
# the coupled 2-level run (3 advances a step, the finer level with the
# wind): the chemistry in each partial update, the wind after each
COUPLED_CALLS = {"chem": 6, "winds": 6, "fill": 6, "glue.prolong": 4,
                 "glue.bc89": 1, "glue.restrict": 1 + 2 * 6, "sweep": 6,
                 "update": 6, "step.dt": 1, "step.select": 2}


@pytest.mark.parametrize("kind,per_step", [
    ("grid", GRID_CALLS), ("hierarchy", HIERARCHY_CALLS),
    ("coupled", COUPLED_CALLS)])
def test_every_leaf_span_fires(kind, per_step):
    """In the "device" mode every span of the step fires as often as the
    step does its work (the chunked steps), and the run loop's spans once
    a chunk; the trace fires inside the chemistry and the dt."""
    run = make_run(kind)
    steps = 4
    if kind == "coupled":
        run.run(max_steps=1)            # the wind's first step alone
        steps = 2
    tracing.enable("device")
    run.run(max_steps=run.step_count + steps, chunk=2)
    spans = tracing.summary()["spans"]
    for name, n in per_step.items():
        assert spans[name]["calls"] == steps * n, name
    for name in ("run.chunk", "run.sources", "run.readback"):
        assert spans[name]["calls"] == steps // 2, name
    assert "run.replay" not in spans
    if kind == "coupled":
        assert spans["trace"]["calls"] > 0
    for name, s in spans.items():
        assert tracing.is_span(name), name
        assert s["host_s"] > 0.0


@pytest.mark.parametrize("outer,inner", [("chem", "trace"),
                                         ("step.dt", "trace"),
                                         ("glue.bc89", "glue.bc89")])
def test_nesting_gives_a_child_its_own_work(outer, inner):
    """Under the profiler the work inside a nested span lies inside its
    own range and the outer span's, so the innermost range at an
    operation is the child's; the registry times each name once (a span
    inside one of its own name is the outer one's)."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable("host")
    a = torch.arange(64.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span(outer):
            x = a * 2.0
            with tracing.span(inner):
                time.sleep(0.02)
                y = torch.cumsum(x, 0)
            z = y - 1.0
    assert float(z[-1]) == float(torch.cumsum(a * 2.0, 0)[-1] - 1.0)
    ranges = {}
    ops = []
    for e in prof.events():
        if e.name in (outer, inner):
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
        elif e.name in ("aten::mul", "aten::cumsum", "aten::sub"):
            ops.append((e.name, e.time_range.start, e.time_range.end))

    def innermost(s, e):
        over = [(hi - lo, name) for name, rs in ranges.items()
                for lo, hi in rs if lo <= s and e <= hi]
        return min(over)[1] if over else None

    got = {name: innermost(s, e) for name, s, e in ops}
    assert got["aten::cumsum"] == inner
    assert got["aten::mul"] == outer and got["aten::sub"] == outer
    spans = tracing.summary()["spans"]
    if outer == inner:
        assert spans[outer]["calls"] == 1 and spans[outer]["host_s"] >= 0.02
    else:
        assert spans[outer]["calls"] == spans[inner]["calls"] == 1
        assert 0.02 <= spans[inner]["host_s"] <= spans[outer]["host_s"]


@pytest.mark.parametrize("mode", [None, "host", "device"])
def test_graph_key_holds_the_mode(mode):
    """The key of a run's chunk graphs holds the tracing mode: a graph
    recorded with tracing off is never the one replayed with it on."""
    sp = {"0": {"rel": torch.ones(())}}
    off = graphs.key(5, sp)
    if mode is not None:
        tracing.enable(mode)
    got = graphs.key(5, sp)
    assert got[:2] == off[:2] == (5, graphs.layout(sp))
    assert (got == off) == (mode is None)
    assert got[2] == mode


@pytest.mark.parametrize("mode", [None, "host"])
def test_ladder_counters_reach_the_update(monkeypatch, mode):
    """The chemistry's update gets the ladder's counter pair only with
    tracing on (no pointer off); on the CPU its plain version counts into
    it what the kernel counts (tiles that ran the ladder, their Newton
    iterations), and ``summary()`` reads them."""
    seen = []
    orig = fused_mpv3.update

    @functools.wraps(orig)          # (its launch counters too)
    def spy(*a, stats=None, **kw):
        seen.append(stats)
        return orig(*a, stats=stats, **kw)

    monkeypatch.setattr(fused_mpv3, "update", spy)
    hier = coupled(kernels="auto")
    if mode is not None:
        tracing.enable(mode)
    hier.run(max_steps=1)
    assert seen
    counters = tracing.summary()["counters"]
    if mode is None:
        assert all(s is None for s in seen)
        return
    pair = tracing.ladder_stats("cpu")
    assert all(s is pair for s in seen)
    tiles, newton = pair.tolist()
    assert counters["chem.ladder_tiles"] == tiles > 0
    assert counters["chem.newton_iters"] == newton >= tiles
    tracing.enable(mode)
    assert tracing.summary()["counters"]["chem.ladder_tiles"] == 0


def test_timers_count_their_intervals():
    """``utils.Timers`` keeps each name's intervals beside its seconds."""
    T = utils.Timers()
    for _ in range(3):
        T.start("a")
        T.pause("a")
    T.start("b")
    assert T.calls("a") == 3 and T.calls("b") == 0
    T.stop("b")
    assert T.calls("b") == 1 and T.calls("c") == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


RANK_CODE = """
import sys, torch
from pion_tpu_torch import tracing
from pion_tpu_torch.parallel import comm
rank, port = int(sys.argv[1]), sys.argv[2]
comm.init_distributed(backend="gloo", init_method="tcp://127.0.0.1:" + port,
                      rank=rank, world_size=2, device="cpu")
x = torch.arange(12.0, dtype=torch.float64).reshape(3, 4) + rank
moves = [comm.Move(src=r, dst=1 - r, send=x if r == rank else None,
                   shape=(3, 4), dtype=torch.float64,
                   device=torch.device("cpu")) for r in (0, 1)]
got = comm.transfer(moves)
c = tracing.summary()["counters"]
print("COUNTS", c["comm.bytes_sent"], c["comm.messages"],
      float(got[1 - rank].sum()))
comm.destroy()
"""


def test_comm_counters_in_summary():
    """Two processes on gloo each send one 3 x 4 float64 block: each
    counts 96 bytes and one message in ``summary()``."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(r), port],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        line = next(ln for ln in out.splitlines() if ln.startswith("COUNTS"))
        sent, msgs, total = line.split()[1:]
        assert int(sent) == 96 and int(msgs) == 1
        assert float(total) == 66.0 + 12.0 * (1 - r)


def test_enable_takes_a_mode():
    with pytest.raises(ValueError, match="tracing mode"):
        tracing.enable("trace")
    tracing.enable("host")
    with tracing.span("run.chunk"):
        with pytest.raises(RuntimeError, match="open span"):
            tracing.enable("device")
    assert tracing.mode() == "host"
