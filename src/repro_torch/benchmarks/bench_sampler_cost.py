# Adapted from benchmarks/bench_sampler_cost.py: the same sizes and rows,
# Algorithm 2's G on the device and every timed call waiting for it.
"""Algorithm cost scaling (Theorems 3 & 4): Algorithm 1 is O(n log n);
Algorithm 2 is O(n^2 d + X) dominated by the similarity matrix.

Algorithm 2's G (n, 256) lies on the device, so its distance stage is one
launch of the similarity kernel (its plain version on the CPU); the Ward
cut and the urns run on the host, as in every plan build.

Also sweeps the *per-draw* cost of every registered sampling scheme in one
table (``sampler_cost/draw/<name>``): each scheme is constructed through
the same spec door experiments use, then its ``sample()`` is timed —
plan-build cost is amortized out, so the rows isolate what a round pays.

``--smoke`` runs one tiny size per algorithm.

Run: ``python -m repro_torch.benchmarks.bench_sampler_cost [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, parse_with_device, timed
from repro_torch.core import ClientPopulation, build_plan_algorithm1, build_plan_algorithm2


def draw_cost_sweep(*, smoke: bool, device="cuda") -> None:
    """Per-draw cost of every scheme in ``SAMPLERS``, one table."""
    from repro_torch.core.samplers import SAMPLERS
    from repro_torch.fl.experiment import build_sampler

    m = 4 if smoke else 10
    n = 5 * m  # uniform sizes + n % m == 0: target's oracle groups are balanced
    update_dim = 32 if smoke else 256
    pop = ClientPopulation(np.full(n, 100))
    oracle_groups = [g.tolist() for g in np.arange(n).reshape(m, -1)]
    for name in SAMPLERS.names():
        options = {"groups": oracle_groups} if name == "target" else {}
        sampler = build_sampler(
            {"name": name, "m": m, "seed": 0, "options": options},
            pop, update_dim=update_dim, device=device,
        )
        try:
            us, _ = timed(lambda: sampler.sample(0), repeats=3 if smoke else 20, device=device)
        finally:
            getattr(sampler, "close", lambda: None)()
        emit(f"sampler_cost/draw/{name}", us, f"n={n};m={m}")


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    args = parse_with_device(ap, argv)

    rng = np.random.default_rng(0)
    a1_sizes = (50,) if args.smoke else (50, 100, 200, 400)
    a2_sizes = (50,) if args.smoke else (50, 100, 200)
    for n in a1_sizes:
        pop = ClientPopulation(rng.integers(50, 1000, size=n))
        us, _ = timed(lambda: build_plan_algorithm1(pop, 10), repeats=5)
        emit(f"sampler_cost/algorithm1/n={n}", us, "theory=O(n log n)")
    for n in a2_sizes:
        pop = ClientPopulation(rng.integers(50, 1000, size=n))
        G = torch.as_tensor(rng.normal(size=(n, 256)), dtype=torch.float32, device=args.device)
        us, _ = timed(lambda: build_plan_algorithm2(pop, 10, G), repeats=2, device=args.device)
        emit(f"sampler_cost/algorithm2/n={n}", us, "theory=O(n^2 d + ward)")
    draw_cost_sweep(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
