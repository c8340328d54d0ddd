"""Cell-updates a step of a hierarchy, and the window's counts of a partial
episode and of lost steps."""
import math

import pytest

from bench_port import harness, problems


def test_hierarchy_counts_each_level_two_to_the_level():
    config = {"sim": {"shape": [128, 128, 128], "nlevels": 3}}
    assert problems.cells_per_step(config) == 128 ** 3 * (1 + 2 + 4)
    assert problems.cells_per_step({"sim": {"shape": [256] * 3}}) == 256 ** 3


class FakeRun:
    """Stands for a program's run: ``run(max_steps, chunk)`` takes the
    chunk's steps (a few ms each), or raises at chosen calls."""

    def __init__(self, raise_at=(), bad_at=()):
        import torch

        self.P = torch.zeros(3)
        self.t, self.step_count, self.last_dt = 0.0, 0, 0.0
        self.calls = 0
        self.raise_at, self.bad_at = set(raise_at), set(bad_at)

    def run(self, max_steps, chunk):
        import time

        self.calls += 1
        if self.calls in self.raise_at:
            raise RuntimeError("planted")
        time.sleep(0.002)
        if self.calls in self.bad_at:
            self.P = self.P + math.nan
        self.t += chunk
        self.step_count = max_steps


def test_partial_episode_counts():
    ep = harness.Episodes(FakeRun(), 2, 6)
    win = harness.window(ep, 0.05)
    assert win["attempted"] == 2 * len(win["chunk_s"])
    assert win["completed"] == win["attempted"]
    assert win["failed"] == 0


def test_rate_counts_the_steps_of_a_partial_episode(root):
    """Seven steps of an episode of ten, three levels: every completed
    step counts, level l 2^l times."""
    ctx = {"window": {"completed": 7, "seconds": 2.0},
           "cells_per_step": problems.cells_per_step(
               {"sim": {"shape": [8, 8, 8], "nlevels": 3}})}
    rate = harness.reader(root, "cell_updates_per_s")(ctx)
    assert rate == pytest.approx(7 * 512 * 7 / 2.0 / 1e6)


def test_restore_at_each_episode_end():
    run = FakeRun()
    ep = harness.Episodes(run, 2, 4)
    seen = []
    for _ in range(5):
        ep.chunk()
        seen.append((run.step_count, run.t))
    assert seen == [(2, 2.0), (4, 4.0), (2, 2.0), (4, 4.0), (2, 2.0)]


def test_raised_chunk_and_non_finite_episode_are_lost():
    ep = harness.Episodes(FakeRun(raise_at={2}, bad_at={4}), 2, 4)
    win = harness.window(ep, 0.06)
    # call 2 raised (2 steps); the episode of calls 3-4 went non-finite
    # and loses both its chunks
    assert win["failed"] >= 2 + 4
    assert win["attempted"] == (win["completed"] + win["failed"])


def test_episode_must_be_whole_chunks():
    with pytest.raises(ValueError):
        harness.Episodes(FakeRun(), 3, 10)


def test_quantile():
    assert harness.quantile([5.0], 0.9) == 5.0
    assert harness.quantile([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0,
                             10.0, 11.0], 0.9) == 10.0


def test_traced_chunks_are_fixed_from_the_episode_start():
    """The traced chunks are the same steps of the episode in every run,
    wherever the window left it."""
    ep = harness.Episodes(FakeRun(), 2, 8)
    for _ in range(3):
        ep.chunk()                  # the window ends mid-episode
    seen = []

    def profile(step_chunk, n):
        for _ in range(n):
            step_chunk()
            seen.append(ep.run.step_count)
        return {"steps": 2 * n}

    harness.traced(ep, {"trace_from": 1, "trace_chunks": 2}, profile)
    assert seen == [4, 6]
    with pytest.raises(ValueError):
        harness.traced(ep, {"trace_from": 3, "trace_chunks": 2}, profile)
