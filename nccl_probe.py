#!/usr/bin/env python3
"""Whether NCCL takes two ranks on one card.

    python3 nccl_probe.py            # needs one CUDA device

Launches two processes on ``cuda:0`` with a launcher's environment (a free
local port), each of which starts a process group on NCCL through
``pion_tpu_torch.parallel.comm.init_distributed`` and tries an all-reduce
and a send and receive of a small tensor, under a time limit.  Prints one
JSON line a rank: what it reached and the error it met, word for word.
Exits 0 when both ranks ran to their end, whatever NCCL answered, and 1
when there is no card.  ``chip_smoke.py`` holds the multi-process paths
on gloo, the one transport that two ranks on one card can share.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

TIMEOUT_S = 120.0


def rank_main() -> int:
    import torch

    from pion_tpu_torch.parallel import comm

    rec = {"rank": int(os.environ["RANK"]), "reached": "start", "error": None}
    try:
        comm.init_distributed(backend="nccl", device="cuda:0",
                              timeout_s=TIMEOUT_S / 2)
        rec["reached"] = "init_process_group"
        x = torch.full((), 1.0 + comm.rank(), device="cuda:0")
        rec["all_reduce"] = float(comm.all_reduce(x, "sum"))
        rec["reached"] = "all_reduce"
        me = comm.rank()
        got = comm.transfer([comm.Move(0, 1, x if me == 0 else None, (),
                                       x.dtype, x.device)])
        torch.cuda.synchronize()
        rec["received"] = None if got[0] is None else float(got[0])
        rec["reached"] = "send_recv"
    except Exception as err:             # the answer is what is recorded
        rec["error"] = f"{type(err).__name__}: {err}"
    finally:
        try:
            comm.destroy()
        except Exception as err:
            rec["destroy_error"] = f"{type(err).__name__}: {err}"
    print(json.dumps(rec), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nccl_probe: no CUDA device", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), LOCAL_RANK="0")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank"], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    while any(p.poll() is None for p in procs) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    timed_out = any(p.poll() is None for p in procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for r, p in enumerate(procs):
        out, err = p.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else json.dumps(
            {"rank": r, "reached": None, "exit": p.returncode,
             "timed_out": timed_out, "stderr_tail": err[-2000:]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(rank_main() if sys.argv[1:2] == ["--rank"] else main())
