"""Tests of the benchmark (CPU, plain PyTorch; no JAX).

Tests that need the card carry the ``card`` marker and skip here: whether a
card is present is decided inside the ``card`` fixture, never at import.
Run them on a machine with an NVIDIA GPU by
``python -m pytest bench_port/tests -m card``.
"""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.fixture
def root():
    return ROOT


def tiny_cell(name: str, n: int = 16, levels: int = 2, chunk: int = 2,
              episode: int = 4, check: int = 2) -> dict:
    """The cell ``name`` of BENCHMARK.json at a size a CPU test holds: n
    cells along the first axis, ``levels`` levels where it has several, a front and a wind of
    two cells, short chunks and episodes."""
    from bench_port import harness

    cell = copy.deepcopy(harness.cell_of(ROOT, name))
    sim = cell["config"]["sim"]
    # n cells along the first axis, the others in the configuration's ratio
    sim["shape"] = [n * s // sim["shape"][0] for s in sim["shape"]]
    if sim.get("nlevels", 1) > 1:
        sim["nlevels"] = levels
    for w in cell["config"].get("winds", []):
        w["radius_finest_cells"] = 2.0
    t = cell["traffic"]
    t.update(chunk=chunk, episode_steps=episode, check_steps=check,
             trace_from=1, trace_chunks=1)
    if "front" in t:
        t["front"]["radius_level0_cells"] = 1.5
    return cell
