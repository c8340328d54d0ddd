"""One run of one cell: set-up, the measured window, the traced chunks, the
comparison with the reference, and the result line.

Everything that belongs to one cell is found by name:

- ``BENCHMARK.json``: the cell (``workloads``), its configuration's file
  (``configs``), and the metrics it reports (``end_to_end``, ``per_layer``);
- ``bench_port/traffic/<traffic>.json``: the mix (``chunk``,
  ``episode_steps``, ``check_steps``, ``trace_from``, ``trace_chunks``,
  ``noise``, ``front``);
- ``bench_port/limits/<cell>.json``: the limit of each compared number;
- ``bench_port/metrics/<metric>.py``: a reader ``read(ctx)`` of each metric,
  which returns a number or None (nothing to read: the metric is left out).

The window replays an episode: ``episode_steps`` steps from the state at
the episode's start, which is then restored on the device (states, clock,
step count) and run again, until the window's seconds are up.  Each call is
the program's own entry, ``run(max_steps=..., chunk=k)``: one CUDA graph
replay and one read-back.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import time
import traceback

# the top-level modules no run may hold once its window has closed
FOREIGN = ("jax", "jaxlib", "flax", "pion_tpu")
BENCH = "bench_port"


class NoDevice(RuntimeError):
    """The run cannot be measured here: no CUDA device, or too few."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_file(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_of(root: str, name: str, bench=None) -> dict:
    """The cell's entry, configuration, traffic, limits and the names of
    its end-to-end and per-layer metrics, found by name."""
    bench = bench_file(root) if bench is None else bench
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m["name"] for m in bench["end_to_end"] if reports(m)]
    layer = [m["name"] for m in bench["per_layer"]
             if reports(m) and m["moves"] in e2e]
    return {
        "cell": cell,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(root, BENCH, "traffic",
                                          cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(root, BENCH, "limits",
                                         name + ".json")),
        "end_to_end": e2e, "per_layer": layer}


def reader(root: str, metric: str):
    """The ``read`` function of ``bench_port/metrics/<metric>.py``."""
    path = os.path.join(root, BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that no run may hold, compared
    whole (``pion_tpu_torch`` is not ``pion_tpu``)."""
    import sys

    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FOREIGN))


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation; one value is its
    own quantile."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    x = q * (len(v) - 1)
    i = min(int(x), len(v) - 2)
    return v[i] + (x - i) * (v[i + 1] - v[i])


class Episodes:
    """The program's run, replaying one episode: ``chunk()`` takes the next
    ``k`` steps through ``run(chunk=k)``, restoring the episode's start
    first once its ``episode_steps`` are done."""

    def __init__(self, run, k: int, episode_steps: int):
        if episode_steps % k:
            raise ValueError(f"an episode of {episode_steps} steps is not "
                             f"whole chunks of {k}")
        self.run, self.k, self.episode_steps = run, k, episode_steps
        self.start = ([P.clone() for P in self.states()], run.t,
                      run.step_count, run.last_dt)
        self.done = 0

    def states(self) -> list:
        P = self.run.P
        return list(P) if isinstance(P, (list, tuple)) else [P]

    def restore(self) -> None:
        P0, t, n, last = self.start
        if isinstance(self.run.P, (list, tuple)):
            self.run.P = [P.clone() for P in P0]
        else:
            self.run.P = P0[0].clone()
        self.run.t, self.run.step_count, self.run.last_dt = t, n, last
        self.done = 0

    def chunk(self) -> int:
        if self.done >= self.episode_steps:
            self.restore()
        before = self.run.step_count
        self.run.run(max_steps=before + self.k, chunk=self.k)
        took = self.run.step_count - before
        self.done += took
        return took

    def finite(self) -> bool:
        import torch

        return all(bool(torch.isfinite(P).all()) for P in self.states())

    def graph(self):
        """The CUDA graph the run recorded, or None (an eager chunk)."""
        run = self.run
        graphs = (run._graphs if hasattr(run, "_graphs")
                  else getattr(run.fns.multi_step, "graphs", {}))
        return next(iter(graphs.values()), None)


def set_up(program, config: dict, traffic: dict, states: list, kernels: str,
           dev) -> Episodes:
    """The program's run on the inputs ``states``, its lead steps taken and
    one warm chunk run (which records the graph), at the episode's start."""
    import torch

    from bench_port import problems

    run = problems.make_run(program, config, states, kernels=kernels,
                            device=dev)
    lead = problems.lead_steps(config)
    if lead:
        run.run(max_steps=lead)
    ep = Episodes(run, int(traffic["chunk"]), int(traffic["episode_steps"]))
    ep.chunk()
    ep.finite()
    ep.restore()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ep


def checked_steps(ep: Episodes, steps: int):
    """The episode's first ``steps`` through the timed entry: the level
    states (copied to the host), the clock and the step count."""
    ep.restore()
    while ep.done < steps:
        ep.chunk()
    got = [P.detach().to("cpu", copy=True) for P in ep.states()]
    return got, ep.run.t, ep.run.step_count


def traced(ep: Episodes, traffic: dict, profile) -> dict:
    """``profile`` of the episode's chunks ``trace_from`` to ``trace_from
    + trace_chunks - 1``, counted from the episode's start, so that every
    run traces the same phase of the same work."""
    first, n = int(traffic["trace_from"]), int(traffic["trace_chunks"])
    if first + n > ep.episode_steps // ep.k:
        raise ValueError(f"chunks {first}..{first + n - 1} are not all in "
                         f"an episode of {ep.episode_steps // ep.k}")
    ep.restore()
    for _ in range(first):
        ep.chunk()
    return profile(ep.chunk, n)


def free(dev) -> None:
    """Return what the freed program held to the device."""
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def window(ep: Episodes, seconds: float) -> dict:
    """Chunks until ``seconds`` have passed.  A chunk that raises loses its
    steps; an episode that ends non-finite loses all of its steps.
    Returns steps attempted, completed and failed, the window's seconds
    (to the end of its last chunk) and each chunk's seconds."""
    attempted = completed = failed = 0
    in_episode = 0
    chunk_s = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if ep.done >= ep.episode_steps:
            if not ep.finite():
                failed += in_episode
                completed -= in_episode
            in_episode = 0
        attempted += ep.k
        c0 = time.perf_counter()
        try:
            took = ep.chunk()
        except Exception:           # noqa: BLE001 -- counted as failed
            traceback.print_exc()
            failed += ep.k
            ep.restore()
            in_episode = 0
            continue
        chunk_s.append(time.perf_counter() - c0)
        completed += took
        in_episode += took
        if took < ep.k:
            failed += ep.k - took
    elapsed = time.perf_counter() - t0
    if in_episode and not ep.finite():
        failed += in_episode
        completed -= in_episode
    return {"attempted": attempted, "completed": completed,
            "failed": failed, "seconds": elapsed, "chunk_s": chunk_s}


def device_info(device) -> dict:
    """The result line's ``device``, with the card's power limit beside
    its numbers."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w()}


def power_limit_w():
    """The card's power limit by ``nvidia-smi``, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             kernels: str = "auto", cell=None) -> dict:
    """One run of ``workload``.  ``cell`` replaces what ``cell_of`` finds
    (a test's small configuration; a test runs it on the CPU with the
    kernels off).  Returns the result line's object; its ``checks`` come
    last."""
    import torch

    import pion_tpu_torch as program
    from bench_port import problems
    from bench_port.reference import compare

    cell = cell_of(root, workload) if cell is None else cell
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    if dev.type == "cuda":
        need = cell["cell"].get("chips", 1)
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < need:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {need}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)

    ctx = {"config": config, "traffic": traffic, "build_load_s": None,
           "graph": None, "profile": None}
    if dev.type == "cuda" and kernels != "off":
        from pion_tpu_torch import _build

        t0 = time.perf_counter()
        _build.load_all()
        ctx["build_load_s"] = time.perf_counter() - t0

    states = problems.initial_states(config, traffic, seed)
    ep = set_up(program, config, traffic, states, kernels, dev)
    ctx["setup_s"] = time.perf_counter() - t_start

    win = window(ep, seconds)
    ctx["window"] = win
    ctx["cells_per_step"] = problems.cells_per_step(config)
    g = ep.graph()
    if g is not None:
        ctx["graph"] = {"capture_s": g.capture_s, "pool_bytes": g.pool_bytes}
    dinfo = device_info(dev)
    ctx["memory_peak_bytes"] = dinfo["memory_peak_bytes"]

    result_extra = {}
    if trace:
        from bench_port import profiling

        prof = traced(ep, traffic, profiling.profile)
        ctx["profile"] = prof
        dinfo["busy_s"] = prof["busy_s"]
        dinfo["window_s"] = prof["window_s"]
        result_extra["breakdown"] = {"device_ops": prof["device_ops"],
                                     "idle_gaps": prof["idle_gaps"]}

    # the comparison: the episode's first check_steps through the timed
    # entry, then the program freed and the reference run on the same
    # inputs (the lead steps too)
    check_steps = int(traffic["check_steps"])
    got, got_t, got_steps = checked_steps(ep, check_steps)
    del ep, g
    free(dev)
    ref, ref_t = compare.reference_run(config, states, got_steps, dev)
    cfg = problems.sim_config(program, config, kernels)
    nums = compare.numbers(got, got_t, ref, ref_t, cfg)
    del ref, got
    lead = problems.lead_steps(config)
    checks = {k_: {"value": v, "limit": float(cell["limits"][k_])}
              for k_, v in nums.items()}
    steps_ok = got_steps == lead + check_steps
    checks["check_steps"] = {"value": got_steps - lead,
                             "limit": check_steps}
    correct = (steps_ok and win["failed"] == 0 and win["completed"] > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for name, c in checks.items()
                       if name != "check_steps"))

    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    units = {m["name"]: m["unit"] for m in bench_metrics(root)}
    metrics = {}
    for name in wanted:
        v = reader(root, name)(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}
    out = {"correct": bool(correct), "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dinfo}
    out.update(result_extra)
    if win["chunk_s"]:
        # not a metric: what the next reader of a spread wants to see
        out["window"] = {"seconds": win["seconds"],
                         "chunks": len(win["chunk_s"]),
                         "chunk_ms_quartiles": [
                             quantile(win["chunk_s"], q) * 1.0e3
                             for q in (0.0, 0.25, 0.5, 0.75, 1.0)]}
    out["checks"] = checks
    return out


def bench_metrics(root: str) -> list:
    bench = bench_file(root)
    return bench["end_to_end"] + bench["per_layer"]
