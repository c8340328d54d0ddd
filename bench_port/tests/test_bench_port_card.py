"""On the card: the command end to end on a cell, and the program's kernels
against the reference at a small size.  Skip without an NVIDIA GPU."""
import json
import os
import subprocess
import sys

import pytest

from bench_port import harness, problems
from bench_port.reference import compare
from conftest import ROOT, tiny_cell

CELLS = [w["name"] for w in harness.bench_file(ROOT)["workloads"]]


@pytest.mark.card
def test_command_on_a_cell(card, root):
    out = subprocess.run(
        [sys.executable, os.path.join(root, "bench_port", "run.py"),
         "--workload", "blast3d.replay", "--seed", str(2 ** 31 + 7),
         "--seconds", "2", "--trace", "0"], cwd=root, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["cell_updates_per_s"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_kernels_against_reference(card, name):
    import pion_tpu_torch

    cell = tiny_cell(name, n=32, chunk=2, episode=4, check=2)
    config, traffic = cell["config"], cell["traffic"]
    states = problems.initial_states(config, traffic, 2 ** 31 + 9)
    ep = harness.set_up(pion_tpu_torch, config, traffic, states, "auto",
                        card)
    got, t, steps = harness.checked_steps(ep, 2)
    del ep
    ref, ref_t = compare.reference_run(config, states, steps, card)
    nums = compare.numbers(got, t, ref, ref_t,
                           problems.sim_config(pion_tpu_torch, config))
    for k, v in nums.items():
        assert v <= cell["limits"][k], (k, v)
