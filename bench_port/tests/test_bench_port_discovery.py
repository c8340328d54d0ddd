"""Cells, configurations, traffic mixes, limits and metric readers are
found by name; a new trio of files with a ``workloads`` entry is picked up
without editing any file that is there."""
import json
import os
import shutil

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
