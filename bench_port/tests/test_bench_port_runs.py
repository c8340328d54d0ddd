"""The harness end to end on the CPU at a small size, with the kernels off:
the episode's restore, the reference against the port, the result line,
and the faults and the control that have to come out not correct."""
import json
import math

import pytest
import torch

from bench_port import harness, problems
from bench_port.reference import compare
from conftest import ROOT, tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
# every cell of BENCHMARK.json, so a cell added there is held here too
CELLS = [w["name"] for w in harness.bench_file(ROOT)["workloads"]]


def run_tiny(root, name, cell=None, seconds=0.5, trace=False, **kw):
    import time

    cell = tiny_cell(name) if cell is None else cell
    return harness.run_cell(root, name, SEED, seconds, trace,
                            time.perf_counter(), device="cpu",
                            kernels="off", cell=cell, **kw)


def test_restore_puts_state_clock_and_steps_back():
    import pion_tpu_torch

    cell = tiny_cell("blast3d.replay")
    states = problems.initial_states(cell["config"], cell["traffic"], SEED)
    ep = harness.set_up(pion_tpu_torch, cell["config"], cell["traffic"],
                        states, "off", CPU)
    start = [P.clone() for P in ep.states()]
    t0, n0, d0 = ep.run.t, ep.run.step_count, ep.run.last_dt
    ep.chunk()
    first = [P.clone() for P in ep.states()]
    assert ep.run.step_count == n0 + 2 and ep.run.t > t0
    ep.restore()
    assert (ep.run.t, ep.run.step_count, ep.run.last_dt) == (t0, n0, d0)
    assert all(torch.equal(a, b) for a, b in zip(ep.states(), start))
    ep.chunk()
    assert all(torch.equal(a, b) for a, b in zip(ep.states(), first))


def test_inputs_repeat_by_seed():
    cell = tiny_cell("ostar3d.front", n=8)
    a = problems.initial_states(cell["config"], cell["traffic"], SEED)
    b = problems.initial_states(cell["config"], cell["traffic"], SEED)
    c = problems.initial_states(cell["config"], cell["traffic"], SEED + 1)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == c[0]).all()
    assert len(a) == 2


def test_result_line(root):
    out = run_tiny(root, "blast3d.replay")
    line = json.dumps(out)
    back = json.loads(line)
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(back)
    assert back["correct"] is True
    assert back["failed"] == 0 and back["attempted"] > 0
    assert set(back["metrics"]) == {"cell_updates_per_s", "peak_mem_gib",
                                    "setup_s"}
    for m in back["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert math.isfinite(m["value"])
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"}
    assert back["device"]["count"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_port(name):
    """The port's plain path and the reference agree at a small size on
    the CPU: the lead steps and one chunk.  The dynamics are the same code
    (bit for bit); the reference takes the chemistry's Newton Jacobian by
    central differences, so the chemistry's groups stand within its
    Newton tolerance (1e-6) of the port's, well inside the cell's
    limits."""
    import pion_tpu_torch

    cell = small(name)
    config, traffic = cell["config"], cell["traffic"]
    states = problems.initial_states(config, traffic, SEED)
    ep = harness.set_up(pion_tpu_torch, config, traffic, states, "off", CPU)
    got, t, steps = harness.checked_steps(ep, 2)
    ref, ref_t = compare.reference_run(config, states, steps, CPU)
    cfg = problems.sim_config(pion_tpu_torch, config, "off")
    nums = compare.numbers(got, t, ref, ref_t, cfg)
    for k, v in nums.items():
        assert v <= cell["limits"][k] / 10, (k, v)


def hierarchy(name: str) -> bool:
    return harness.cell_of(ROOT, name)["config"]["sim"].get("nlevels", 1) > 1


def small(name: str) -> dict:
    """The cell at the size of these tests: 16 cells along the first axis
    of a single grid, two levels of 8 of a hierarchy."""
    return tiny_cell(name, n=8 if hierarchy(name) else 16)


def levels(run) -> list:
    return run.P if isinstance(run.P, list) else [run.P]


def put(run, states: list) -> None:
    run.P = states if isinstance(run.P, list) else states[0]


def frozen(orig):
    """A run whose step returns its state unchanged (the clock moves)."""
    def run(self, *a, **kw):
        before = [P.clone() for P in levels(self)]
        out = orig(self, *a, **kw)
        put(self, before)
        return out
    return run


def half_left_out(orig):
    """A run that updates only half of each grid (the other half keeps its
    state)."""
    def run(self, *a, **kw):
        before = [P.clone() for P in levels(self)]
        out = orig(self, *a, **kw)
        n = before[0].shape[1] // 2
        put(self, [torch.cat([b[:, :n], a_[:, n:]], dim=1)
                   for b, a_ in zip(before, levels(self))])
        return out
    return run


def one_cell_altered(orig):
    """A run that alters one cell's answer where it is produced."""
    def run(self, *a, **kw):
        out = orig(self, *a, **kw)
        P = [x.clone() for x in levels(self)]
        P[0][0, 3, 4, 5] *= 1.5
        put(self, P)
        return out
    return run


@pytest.mark.parametrize("fault", [frozen, half_left_out, one_cell_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(root, monkeypatch, name, fault):
    """The harness run end to end with the timed path broken underneath:
    ``correct`` comes out false."""
    import pion_tpu_torch

    cls = (pion_tpu_torch.NGHierarchy if hierarchy(name)
           else pion_tpu_torch.Simulation)
    monkeypatch.setattr(cls, "run", fault(cls.run))
    out = run_tiny(root, name, cell=small(name))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference with its state in bfloat16, put in the program's
    place, fails the cell's limits."""
    cell = small(name)
    config = cell["config"]
    states = problems.initial_states(config, cell["traffic"], SEED)
    steps = problems.lead_steps(config) + cell["traffic"]["check_steps"]
    ctl, ctl_t = compare.reference_run(config, states, steps, CPU,
                                       control=True)
    ref, ref_t = compare.reference_run(config, states, steps, CPU)
    nums = compare.numbers(ctl, ctl_t, ref, ref_t,
                           problems.sim_config(problems.reference_of(config),
                                               config, "off"))
    assert any(v > cell["limits"][k] for k, v in nums.items()), nums
