"""The comparison's control and its planted faults, read at a cell's size.

The control is the plain reference put in the program's place one
precision below the bf16 the configuration states: every matrix product
through float8 e4m3 (:class:`perfbench.reference.lm.Model` ``quant="fp8"``).
The faults, planted in the reference put in the program's place: ``half``
trains each client on the first half of its batch, the mean taken over
it. (A step that leaves its state unchanged reads 1 on ``first_gap`` and
``change_gap`` by their definition, and needs no run.) Each is compared with
the float32 reference by the cell's own numbers (:mod:`perfbench.check`),
on the same inputs and draws: the checked rounds' clients are drawn from
the cold-start plan with the seed's generator, and judged by
:func:`perfbench.check.verdict` against the cell's limits, as a run is.

    python3 -m perfbench.control --workload qwen2-1.5b.alg2_srp --seeds 11,12,13

prints one JSON line a seed: each planted run's numbers beside their
limits, and its ``correct``, which has to come out false.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

from perfbench import check, spec


def schedule(traffic: dict, seed: int) -> list:
    """The checked rounds' draws (stack order, distinct clients first) and
    observed rows, from the cold-start plan."""
    from perfbench.reference import sampling

    n, m = traffic["n_clients"], traffic["m"]
    n_samples = np.full(n, traffic["client_samples"])
    d_prime = traffic.get("planner", {}).get("sketch_dim") or 0
    if traffic["sampler"]["name"] == "md":
        plan = sampling.md_plan(n_samples, m)
    else:
        plan = sampling.algorithm2_plan(np.zeros((n, d_prime)), n_samples, m) / n_samples.sum()
    rng = np.random.default_rng(int(seed))
    cursor = np.zeros(n, dtype=np.int64)
    rounds = []
    for _ in range(traffic["checked_rounds"]):
        clients = sampling.draw(plan, rng)
        js = []
        for c in clients:
            js.append([int(cursor[c]) + i for i in range(traffic["local_steps"])])
            cursor[c] += traffic["local_steps"]
        ids, first = np.unique(clients, return_index=True)
        order = np.concatenate([first, np.setdiff1d(np.arange(m), first)])
        rounds.append({"draws": [(int(clients[i]), js[i]) for i in order],
                       "observed": list(range(len(ids)))})
    return rounds


def numbers(ref: dict, other: dict, traffic: dict) -> dict:
    keep = check.kept_leaves(ref["first_norms"].numpy())
    out = {
        "loss_gap": check.loss_gap(other["losses"], ref["losses"]),
        "first_gap": check.leaf_gap(other["first_norms"].numpy(), ref["first_norms"].numpy(), keep),
        "change_gap": check.leaf_gap(other["change_norms"].numpy(), ref["change_norms"].numpy(), keep),
    }
    if ref["sketches"]:
        n_rounds = len(ref["losses"])
        d_prime = traffic["planner"]["sketch_dim"]
        mine = [(r, c, row.numpy(), rms) for r, c, row, rms in other["sketches"]]
        want = [(r, c, row.numpy(), rms) for r, c, row, rms in ref["sketches"]]
        out["sketch_gap"] = check.sketch_gap(
            check.stores_of(mine, n_rounds, traffic["n_clients"], d_prime),
            check.latest_rows(want, n_rounds))
    return out


def judged(nums: dict, limits: dict) -> dict:
    """The numbers, each beside the cell's limit, and the verdict the
    benchmark's own comparison gives them."""
    ok, checks = check.verdict(nums, limits)
    return {"correct": ok, "checks": checks,
            "not_compared": {k: v for k, v in nums.items() if k not in checks}}


def read(workload: str, seed: int, device) -> dict:
    from perfbench.reference import federated

    cell = spec.cell(workload)
    traffic, a = cell["traffic_file"], spec.arch(cell["config_file"])
    rounds = schedule(traffic, seed)
    out = {"seed": seed, "seconds": {}}
    t0 = time.perf_counter()
    kw = dict(device=device, signs=federated.signs_for(a, traffic, seed, device))
    ref = federated.run(a, traffic, seed, rounds, **kw)
    out["seconds"]["reference"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp8 = numbers(ref, federated.run(a, traffic, seed, rounds, quant="fp8", **kw), traffic)
    out["control"] = judged(fp8, cell["limits"])
    out["seconds"]["control"] = time.perf_counter() - t0
    half = copy.deepcopy(traffic)
    half["half_batch"] = True
    t0 = time.perf_counter()
    out["half"] = judged(numbers(ref, federated.run(a, half, seed, rounds, **kw), traffic),
                         cell["limits"])
    out["seconds"]["half"] = time.perf_counter() - t0
    out["losses_ref"] = ref["losses"]
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        res = read(args.workload, int(s), torch.device("cuda", 0))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
