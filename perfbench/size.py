"""Size a cell's local batch on the card: for each candidate (B × S), the
device's idle share, each round's wall time, the peak memory and the
allocator's retries over a few traced rounds after two warm-up rounds.

    python3 -m perfbench.size --workload qwen2-1.5b.alg2_srp --seed 7 \\
        --batches 4x1024,4x2048,2x4096 --rounds 4

Prints one JSON line a candidate. The cell's mix is kept whole but for
``local_batch`` and ``seq_len``; no reference runs.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time

from perfbench import run as bench_run  # noqa: F401  (sets the caches and sys.path)
from perfbench import spec


def measure(cell: dict, batch: int, seq: int, seed: int, rounds: int) -> dict:
    import torch
    from torch.profiler import profile, record_function

    from perfbench import trace
    from perfbench.driver import Federation

    traffic = copy.deepcopy(cell["traffic_file"])
    traffic.update(local_batch=batch, seq_len=seq)
    dev = torch.device("cuda", 0)
    fed = Federation(cell["config_file"], traffic, seed, dev)
    for t in range(2):
        fed.round(t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries_0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    records = []
    with profile(activities=trace.activities()) as prof:
        for t in range(2, 2 + rounds):
            with record_function(trace.ROUND):
                records.append(fed.round(t))
    tr = trace.Trace(prof.profiler.kineto_results.events())
    out = {
        "batch": f"{batch}x{seq}",
        "idle_share": 100.0 * (1.0 - tr.busy_s / tr.window_s),
        "round_s": [r["round_s"] for r in records],
        "tokens_per_s": fed.tokens_per_round * len(records) / sum(r["round_s"] for r in records),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / float(1 << 30),
        "alloc_retries": torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries_0,
        "idle_gaps": tr.idle_gaps(5),
        "device_ops": tr.top_ops(5),
    }
    fed.close()
    del fed, tr, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batches", default="4x1024,4x2048,2x4096")
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    for cand in args.batches.split(","):
        b, s = (int(x) for x in cand.split("x"))
        t0 = time.perf_counter()
        res = measure(cell, b, s, args.seed, args.rounds)
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
