"""The readings a cell's limits are set from, in one process on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--out chiprun_out/calib.jsonl]

For each seed: the program's numbers (its timed entry over the check's
steps, against the reference from the same inputs), and for each control
seed also the control's (the reference with its state held in bfloat16,
put in the program's place).  One JSON line a reading.  The benchmark's own
runs do not run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import pion_tpu_torch
    from bench_port import harness, problems
    from bench_port.reference import compare
    from pion_tpu_torch import _build

    cell = harness.cell_of(ROOT, args.workload)
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device("cuda", 0)
    _build.load_all()
    cfg = problems.sim_config(pion_tpu_torch, config)
    steps = int(traffic["check_steps"])
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        states = problems.initial_states(config, traffic, seed)
        t0 = time.perf_counter()
        ep = harness.set_up(pion_tpu_torch, config, traffic, states, "auto",
                            dev)
        got, got_t, got_steps = harness.checked_steps(ep, steps)
        prog_s = time.perf_counter() - t0
        del ep
        harness.free(dev)
        t0 = time.perf_counter()
        ref, ref_t = compare.reference_run(config, states, got_steps, dev)
        ref_s = time.perf_counter() - t0
        rows = [{"seed": seed, "side": "program",
                 **compare.numbers(got, got_t, ref, ref_t, cfg),
                 "program_s": prog_s, "reference_s": ref_s,
                 "steps": got_steps}]
        del got
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            ctl, ctl_t = compare.reference_run(config, states, got_steps,
                                               dev, control=True)
            rows.append({"seed": seed, "side": "control",
                         **compare.numbers(ctl, ctl_t, ref, ref_t, cfg),
                         "control_s": time.perf_counter() - t0})
            del ctl
        del ref
        harness.free(dev)
        for row in rows:
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
