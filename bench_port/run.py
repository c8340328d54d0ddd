"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  Prints the
compared numbers beside their limits as the last lines on standard error and
one JSON object as the last line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``; then ``window`` (the chunks' host-clock quartiles, not a
metric) and last ``checks``.  Exits non-zero and prints no result
without a CUDA device, without the program beside it, or where the process
holds JAX or the JAX package once the window has closed.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds; the program's own CUDA libraries go to
    ``pion_tpu_torch/build/`` there."""
    base = os.path.join(ROOT, "bench_port", "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, ROOT)
    from bench_port import harness

    try:
        import pion_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"the program pion_tpu_torch is not beside the benchmark: "
              f"{err}", file=sys.stderr)
        return 3
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                               bool(args.trace), _T_START)
    except harness.NoDevice as err:
        print(f"cannot measure here: {err}", file=sys.stderr)
        return 2
    held = harness.foreign_modules()
    if held:
        print(f"the process holds {', '.join(held)} after the window",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
