"""The reader of ``sweep.planes_per_step``: the program's counter
``fused_sweep.sweep_axis.planes`` from pass (a) over the traced steps, and
nothing where the program has no such counter or no spans."""
import pytest

from bench_port import harness


def ctx_of(counters, steps=5):
    return {"spans": {"host": {"counters": counters}},
            "profile": {"steps": steps}}


@pytest.mark.parametrize("counters,steps,want", [
    ({"fused_sweep.sweep_axis.planes": 270, "sweep._slab_faces.sweeps": 0},
     5, 54.0),
    ({"fused_sweep.sweep_axis.planes": 0}, 5, 0.0),
    # a program older than the counter (the parent of the reader)
    ({"fused_sweep.sweep_axis": 105}, 5, None),
    ({"fused_sweep.sweep_axis.planes": 10}, 0, None)])
def test_planes_per_step(root, counters, steps, want):
    read = harness.reader(root, "sweep.planes_per_step")
    assert read(ctx_of(counters, steps)) == want


def test_planes_per_step_without_spans(root):
    read = harness.reader(root, "sweep.planes_per_step")
    assert read({"spans": None, "profile": {"steps": 5}}) is None
