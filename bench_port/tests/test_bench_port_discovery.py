"""Cells, configurations, traffic mixes, limits and metric readers are
found by name; a new trio of files with a ``workloads`` entry is picked up
without editing any file that is there, and so is a configuration with a
reference package and a builder of its own."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import harness


def test_every_cell_finds_its_files(root):
    bench = harness.bench_file(root)
    for w in bench["workloads"]:
        cell = harness.cell_of(root, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["chunk"] >= 1
        assert set(cell["limits"]) == {"state_l1", "state_linf",
                                       "clock_rel"}
        assert "setup_s" in cell["end_to_end"]
        assert cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(harness.reader(root, m))


def test_benchmark_names_its_files(root):
    bench = harness.bench_file(root)
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(root, c["file"]))
        assert c["file"].startswith(bench["paths"][0] + "/")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["per_layer"]:
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]


def test_new_cell_is_found_without_edits(root, tmp_path):
    """A later PR's additions: a configuration file, a traffic file, a
    limits file and a metric reader, with their entries in BENCHMARK.json;
    every file that was there stays as it was."""
    new = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "bench_port"), new / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (new / "bench_port").rglob("*")
               if x.is_file())}
    bench = harness.bench_file(root)
    cfg = json.load(open(os.path.join(root, bench["configs"][1]["file"])))
    cfg["name"] = "blast3d_glm128"
    cfg["sim"]["shape"] = [128, 128, 128]
    (new / "bench_port/configs/blast3d_glm128.json").write_text(
        json.dumps(cfg))
    (new / "bench_port/traffic/replay_k5.json").write_text(json.dumps(
        {"chunk": 5, "episode_steps": 100, "check_steps": 5,
         "trace_chunks": 2, "noise": 1e-3}))
    (new / "bench_port/limits/blast3d.small.json").write_text(json.dumps(
        {"state_l1": 1e-3, "state_linf": 1e-2, "clock_rel": 1e-4}))
    (new / "bench_port/metrics/loop.steps_per_chunk.py").write_text(
        "def read(ctx):\n    return ctx['traffic']['chunk']\n")
    bench["configs"].append(dict(bench["configs"][1], name="blast3d_glm128",
                                 file="bench_port/configs/"
                                      "blast3d_glm128.json"))
    bench["workloads"].append({"name": "blast3d.small",
                               "config": "blast3d_glm128",
                               "traffic": "replay_k5", "chips": 1,
                               "why": "a smaller grid"})
    bench["per_layer"].append({"name": "loop.steps_per_chunk",
                               "unit": "steps", "better": "higher",
                               "source": "program_counter",
                               "layer": "run loop",
                               "moves": "cell_updates_per_s",
                               "workloads": ["blast3d.small"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.cell_of(str(new), "blast3d.small")
    assert cell["config"]["sim"]["shape"] == [128, 128, 128]
    assert cell["traffic"]["chunk"] == 5
    assert cell["limits"]["state_l1"] == 1e-3
    assert "loop.steps_per_chunk" in cell["per_layer"]
    assert harness.reader(str(new), "loop.steps_per_chunk")(cell) == 5
    # the old cells do not report the new cell's metric
    old = harness.cell_of(str(new), "blast3d.replay")
    assert "loop.steps_per_chunk" not in old["per_layer"]
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


PROBE_REFERENCE = '''"""A reference that re-exports port_plain and counts the runs built
from it{fault}."""
from bench_port.reference import port_plain
from bench_port.reference.port_plain import *  # noqa: F401,F403
from bench_port.reference.port_plain import (  # noqa: F401
    constants, ics, microphysics, physics, raytracing)

FAULTY = {faulty}
BUILDS = []


class Simulation(port_plain.Simulation):
    def __init__(self, *a, **kw):
        BUILDS.append("Simulation")
        super().__init__(*a, **kw)

    def run(self, *a, **kw):
        out = super().run(*a, **kw)
        if FAULTY:
            P = self.P.clone()
            P[0, 3, 4] *= 1.5
            self.P = P
        return out


class NGHierarchy(port_plain.NGHierarchy):
    def __init__(self, *a, **kw):
        BUILDS.append("NGHierarchy")
        super().__init__(*a, **kw)
'''

PROBE_BUILDER = '''"""A 2D Cartesian GLM blast in a medium that moves along one axis."""
import numpy as np

CALLS = []


def initial_states(ref, config, traffic, seed):
    from bench_port.problems import sim_config

    CALLS.append(seed)
    cfg = sim_config(ref, config, kernels="off")
    m = config["moving"]
    P = ref.ics.blast_wave(cfg, rho0=m["rho0"], p0=m["p0"],
                           p_in=m["p_in"], r_in=m["r_in"], B0=m["B0"])
    P[2 + m["axis"]] = m["v"]
    rng = np.random.default_rng([seed % 2 ** 64, 0])
    P[0] *= 1.0 + traffic["noise"] * (rng.random(cfg.shape) - 0.5)
    return [P]
'''

PROBE_CONFIG = {
    "name": "probe2d", "reference": "probe_plain", "builder": "probe",
    "sim": {"ndim": 2, "eqn": "glm", "solver": "hlld", "ntracer": 0,
            "shape": [16, 24], "xmin": [-0.5, -0.75], "xmax": [0.5, 0.75],
            "bcs": [["periodic", "periodic"], ["periodic", "periodic"]],
            "cfl": 0.3, "ooa": 2, "av": "falle", "etav": 0.1,
            "dtype": "float32", "tmax": 1.0},
    "moving": {"rho0": 1.0, "p0": 0.1, "p_in": 10.0, "r_in": 0.2,
               "B0": [0.5, 0.5, 0.0], "v": 0.75, "axis": 1}}

PROBE_RUN = '''
import json, sys, time
from bench_port import harness, problems
cell = harness.cell_of(".", "probe2d.moving")
states = problems.initial_states(cell["config"], cell["traffic"], 7)
out = harness.run_cell(".", "probe2d.moving", 2 ** 31 + 77, 0.3, False,
                       time.perf_counter(), device="cpu", kernels="off")
ref = sys.modules["bench_port.reference.probe_plain"]
builder = sys.modules["bench_port.builders.probe"]
print(json.dumps({"out": out, "builds": ref.BUILDS,
                  "seeds": builder.CALLS, "ref_file": ref.__file__,
                  "builder_file": builder.__file__,
                  "moving": float(states[0][3].min())}))
'''


@pytest.mark.parametrize("faulty", [False, True])
def test_new_configuration_is_found_without_edits(root, tmp_path, faulty):
    """A later PR's configuration with a reference package and a builder
    of its own, added as new files and entries beside a copy of the
    benchmark: ``run_cell`` finds them by name and runs the cell end to end
    on the CPU with the probe's inputs and reference, and no file that was
    there changes; only ``BENCHMARK.json`` gains entries.  A faulty
    reference (a cell altered after each step) comes out not correct."""
    new = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "bench_port"), new / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "cache"))
    before = {p: p.read_bytes() for p in new.rglob("*") if p.is_file()}
    bench = harness.bench_file(root)
    pkg = new / "bench_port/reference/probe_plain"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(PROBE_REFERENCE.format(
        faulty=faulty, fault=", and alters a cell after each step"
        if faulty else ""))
    (new / "bench_port/builders").mkdir()
    (new / "bench_port/builders/probe.py").write_text(PROBE_BUILDER)
    (new / "bench_port/configs/probe2d.json").write_text(
        json.dumps(PROBE_CONFIG))
    (new / "bench_port/traffic/probe_k1.json").write_text(json.dumps(
        {"chunk": 1, "episode_steps": 3, "check_steps": 3,
         "trace_from": 1, "trace_chunks": 1, "noise": 1e-3}))
    (new / "bench_port/limits/probe2d.moving.json").write_text(json.dumps(
        {"state_l1": 1e-6, "state_linf": 1e-5, "clock_rel": 1e-6}))
    bench["configs"].append({"name": "probe2d",
                             "source": "a test's configuration",
                             "file": "bench_port/configs/probe2d.json",
                             "reduced": [], "why": "a probe"})
    bench["workloads"].append({"name": "probe2d.moving",
                               "config": "probe2d", "traffic": "probe_k1",
                               "chips": 1, "why": "a probe"})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    # the copy's bench_port first, the program from the repository
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(new), root]))
    proc = subprocess.run([sys.executable, "-c", PROBE_RUN], cwd=new,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    out = got["out"]
    assert got["ref_file"] == str(pkg / "__init__.py")
    assert got["builder_file"] == str(new / "bench_port/builders/probe.py")
    assert got["builds"] == ["Simulation"]
    assert got["seeds"] == [7, 2 ** 31 + 77]
    assert got["moving"] == 0.75
    assert out["checks"]["check_steps"]["value"] == 3
    assert out["correct"] is (not faulty), out["checks"]
    if faulty:
        assert out["checks"]["state_linf"]["value"] > 1e-2
    else:
        assert out["failed"] == 0 and out["attempted"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
