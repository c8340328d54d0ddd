"""The readers of the program's spans and counters (``bench_port/spans.py``
and the metrics that name it): attribution on a synthetic profile, and a
``--trace 1`` run of a tiny cell on the CPU, where nothing runs on a device
and the device metrics are left out."""
import json
import math
import sys

import pytest
import torch

from bench_port import harness, spans
from conftest import tiny_cell

SEED = 2 ** 31 + 12345


def is_span(name):
    from pion_tpu_torch import tracing

    return tracing.is_span(name)


def test_innermost_takes_the_nested_range():
    ranges = [(0.0, 100.0, "outer"), (10.0, 20.0, "inner"),
              (10.0, 15.0, "inmost"), (40.0, 60.0, "apart")]
    got = spans.innermost([5.0, 12.0, 17.0, 50.0, 80.0, 150.0], ranges)
    assert got == ["outer", "inmost", "inner", "apart", "outer", None]


def eager_record():
    """Pass (b) of one step: device ops under nested annotations (the
    trace inside the chemistry), two under the run loop's span only and
    one under none."""
    notes = [(5.0, 15.0, "fill"),
             (20.0, 60.0, "chem"), (30.0, 40.0, "trace"),
             (0.0, 200.0, "run.chunk")]
    ops = [(6.0, 14.0, "void at::native::vectorized_elementwise_kernel"),
           (22.0, 28.0, "void at::native::elementwise_kernel"),
           (31.0, 39.0, "void pion::octant_trace_cluster_kernel<float>"),
           (41.0, 50.0, "void pion::update_ladder_kernel<float, 2>"),
           (70.0, 80.0, "void at::native::reduce_kernel"),
           (150.0, 160.0, "Memcpy DtoD (Device -> Device)"),
           (210.0, 215.0, "void at::native::elementwise_kernel")]
    calls = {"fill": 2, "chem": 2, "trace": 1, "run.chunk": 1}
    return {"steps": 1, "chunks": 1, "ops": notes + ops, "cpu": [],
            "registry": {"spans": {n: {"calls": c, "host_s": 1e-3}
                                   for n, c in calls.items()},
                         "counters": {}}}


def test_eager_pass_sums_each_op_under_its_innermost_span():
    from pion_tpu_torch import tracing

    e = spans.eager_pass(eager_record(), is_span, tracing.RUN_SPANS)
    ms = e["device_ms_per_step"]
    assert ms["fill"] == pytest.approx(0.008)
    assert ms["trace"] == pytest.approx(0.008)
    assert ms["chem"] == pytest.approx(0.006 + 0.009)
    assert ms["run.chunk"] == pytest.approx(0.020)
    assert ms[spans.NO_SPAN] == pytest.approx(0.005)
    # under no span of the step's body: the run loop's and none
    assert e["unattributed_ms_per_step"] == pytest.approx(0.025)
    # B3 and B5 are not plain
    assert e["plain_ms_per_step"]["chem"] == pytest.approx(0.006)
    assert "trace" not in e["plain_ms_per_step"]
    assert e["busy_ms_per_step"] == pytest.approx(0.056)
    assert [n for n, _ in e["top_ops"]["chem"]] == [
        "void pion::update_ladder_kernel<float, 2>",
        "void at::native::elementwise_kernel"]


@pytest.mark.parametrize("metric,want", [
    ("fill.device_ms_per_step", 0.008),
    ("chem.plain_ms_per_step", 0.006),
    ("glue.device_ms_per_step", None),
    ("dt.device_ms_per_step", None),
])
def test_device_readers(root, metric, want):
    """Each reader takes its spans of pass (b); a span the cell does not
    have (no glue, no dt here) leaves its metric out."""
    from pion_tpu_torch import tracing

    ctx = {"spans": {"eager": spans.eager_pass(eager_record(), is_span,
                                               tracing.RUN_SPANS)}}
    got = harness.reader(root, metric)(ctx)
    assert got == (None if want is None else pytest.approx(want))


def host_record():
    """Pass (a) of one chunk of 5 steps: the device busy around the
    replay, idle once while the host waits in ``run.readback`` and once
    after it; the graph's launch inside the replay, and a runtime call
    inside the read-back, which is not the host's own."""
    cpu = [(0.0, 1000.0, "run.chunk"), (0.0, 100.0, "run.sources"),
           (100.0, 300.0, "run.replay"), (300.0, 900.0, "run.readback"),
           (110.0, 290.0, "cudaGraphLaunch"),
           (290.0, 295.0, "cudaLaunchKernel"),
           (310.0, 320.0, "aten::item"),
           (320.0, 880.0, "cudaStreamSynchronize")]
    ops = [(120.0, 500.0, "kernel"), (520.0, 880.0, "kernel"),
           (950.0, 990.0, "kernel"),
           # the replay's annotation over its kernels: not device work
           (120.0, 990.0, "run.replay")]
    return {"steps": 5, "chunks": 1, "cpu": cpu, "ops": ops,
            "registry": {"spans": {"run.chunk": {"calls": 1,
                                                 "host_s": 1.0e-3},
                                   "run.readback": {"calls": 1,
                                                    "host_s": 6.0e-4}},
                         "counters": {"chem.ladder_tiles": 10,
                                      "chem.newton_iters": 40}}}


def test_host_pass_names_gaps_and_splits_chunks(root):
    h = spans.host_pass(host_record(), is_span)
    gaps = dict(h["idle_gaps"])
    assert gaps == {"run.chunk": pytest.approx(70e-6),
                    "run.readback": pytest.approx(20e-6)}
    assert h["chunks"] == [{"run.chunk": 1.0, "run.sources": 0.1,
                            "run.replay": 0.2, "run.readback": 0.6,
                            "cudaGraphLaunch": 0.18}]
    assert h["runtime_ms_per_chunk"] == {
        "cudaGraphLaunch": pytest.approx(0.18),
        "cudaLaunchKernel": pytest.approx(0.005)}
    # the chunk less the read-back less the graph's launch
    assert h["loop_ms_per_chunk"] == pytest.approx(0.22)
    assert h["busy_ms_per_step"] == pytest.approx(0.78 / 5)
    ctx = {"spans": {"host": h}}
    assert harness.reader(root, "chem.ladder_tiles_per_step")(ctx) == 2.0
    assert harness.reader(root, "chem.newton_per_ladder_tile")(ctx) == 4.0
    assert harness.reader(root, "loop.host_ms_per_chunk")(ctx) == \
        pytest.approx(0.22)


def test_changed_takes_the_difference():
    before = {"spans": {"a": {"calls": 1, "host_s": 1.0}},
              "counters": {"x": 3, "graph.replays": {"g": 2}}}
    after = {"spans": {"a": {"calls": 1, "host_s": 1.0},
                       "b": {"calls": 2, "host_s": 0.5}},
             "counters": {"x": 5, "graph.replays": {"g": 4, "h": 1},
                          "graph.captures": {"g": 1}}}
    got = spans.changed(before, after)
    assert got["spans"] == {"b": {"calls": 2, "host_s": 0.5}}
    assert got["counters"] == {"x": 2, "graph.replays": {"g": 2, "h": 1},
                               "graph.captures": {"g": 1}}


@pytest.mark.parametrize("case", ["outside run_cell", "untraced run",
                                  "a pass fails", "without tracing"])
def test_passes_fail_the_run_where_the_program_traces(monkeypatch, case):
    """With ``tracing`` in the program, readers that cannot find the run's
    inputs or its traced pass, or a pass that raises, fail the run (the
    tracing left off); against a program without it the metrics are left
    out."""
    from pion_tpu_torch import tracing

    ctx = {"profile": None if case == "untraced run" else {"steps": 1}}
    if case == "without tracing":
        import pion_tpu_torch

        monkeypatch.setitem(sys.modules, "pion_tpu_torch.tracing", None)
        monkeypatch.delattr(pion_tpu_torch, "tracing")
        assert spans.result(ctx) is None
        return
    if case == "a pass fails":
        def fail(*a, **k):
            tracing.enable("host")
            raise ValueError("a pass failed")

        monkeypatch.setattr(spans, "_run_inputs",
                            lambda: {"dev": torch.device("cpu")})
        monkeypatch.setattr(spans, "_passes", fail)
    with pytest.raises(ValueError if case == "a pass fails"
                       else RuntimeError):
        spans.result(ctx)
    assert tracing.mode() is None


def run_traced(root, monkeypatch, name):
    import time

    # the profiled pass ends in a synchronise: nothing to wait for here
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return harness.run_cell(root, name, SEED, 0.5, True, time.perf_counter(),
                            device="cpu", kernels="off",
                            cell=tiny_cell(name))


HOST_ONLY = {"loop.chunk_ms_p90", "loop.host_ms_per_chunk"}


@pytest.mark.parametrize("program", ["with tracing", "without tracing"])
def test_traced_run_on_the_cpu(root, monkeypatch, capsys, program):
    """A ``--trace 1`` run of the tiny blast on the CPU: the host metrics
    come out as numbers, the device metrics are left out, ``checks`` stays
    last, and the spans line goes to standard error.  Against a program
    without ``tracing`` (the parent of this module) the new metrics are
    left out and nothing raises."""
    if program == "without tracing":
        import pion_tpu_torch

        monkeypatch.setitem(sys.modules, "pion_tpu_torch.tracing", None)
        monkeypatch.delattr(pion_tpu_torch, "tracing")
    out = run_traced(root, monkeypatch, "blast3d.replay")
    back = json.loads(json.dumps(out))
    assert list(back)[-1] == "checks"
    assert back["correct"] is True
    want = HOST_ONLY if program == "with tracing" else {"loop.chunk_ms_p90"}
    assert set(back["metrics"]) == want
    for m in back["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0.0
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("spans ")]
    if program == "without tracing":
        assert not lines
        return
    got = json.loads(lines[0][len("spans "):])
    assert got["eager"] is None
    assert got["host"]["chunks"] and "run.chunk" in got["host"]["chunks"][0]
    assert got["host"]["counters"].get("graph.captures", {}) == {}
    assert got["cost"]["added_s"] > 0.0
