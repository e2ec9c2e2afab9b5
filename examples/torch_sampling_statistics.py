"""Explore clustered-sampling plans and their statistics on YOUR population,
with the PyTorch port.

Prints the r_{k,i} matrix for Algorithms 1/2 next to MD sampling, with the
paper's closed-form statistics per client (variance, inclusion probability,
max draws) — the fastest way to understand what the urn-filling does. As
``examples/sampling_statistics.py``, plus ``--device``: Algorithm 2's
gradient store and similarity op run there (the card by default;
``--device cpu`` runs the similarity kernel's plain version).

Run:  PYTHONPATH=src python examples/torch_sampling_statistics.py \
          --sizes 100 100 300 300 700 1000 --m 4 [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    ClientPopulation,
    build_plan_algorithm1,
    max_draws_bound,
    validate_plan,
)
from repro_torch.core.statistics import (
    clustered_inclusion_probability,
    clustered_weight_variance,
    md_inclusion_probability,
    md_weight_variance,
)
from repro_torch.device import resolve_device
from repro_torch.fl.experiment import build_sampler


def show_plan(name, r):
    print(f"\n{name} — r[k, i] (rows = distributions W_k):")
    for k in range(r.shape[0]):
        print("   W_%d  " % k + " ".join(f"{v:5.2f}" for v in r[k]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[100, 100, 300, 300, 700, 1000])
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="device of Algorithm 2's store (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    pop = ClientPopulation(np.array(args.sizes))
    m = args.m
    p = pop.importances
    print(f"population: n={pop.n_clients} clients, M={pop.total_samples} samples, m={m}")
    print("p_i: " + " ".join(f"{v:5.2f}" for v in p))

    plan1 = build_plan_algorithm1(pop, m)
    validate_plan(plan1, pop)
    show_plan("Algorithm 1 (sample-size urns)", plan1.r)

    s2 = build_sampler({"name": "algorithm2", "m": m, "seed": 0}, pop, update_dim=8,
                       device=args.device)
    rng = np.random.default_rng(0)
    s2.observe_updates(np.arange(pop.n_clients), rng.normal(size=(pop.n_clients, 8)))
    show_plan("Algorithm 2 (similarity urns, random gradients)", s2.plan.r)
    s2.close()

    print("\nper-client statistics (MD -> Algorithm 1):")
    v_md, v_c = md_weight_variance(p, m), clustered_weight_variance(plan1)
    q_md, q_c = md_inclusion_probability(p, m), clustered_inclusion_probability(plan1)
    print(f"  {'i':>3} {'p_i':>6} {'Var_MD':>9} {'Var_C':>9} {'P_MD':>6} {'P_C':>6} {'max draws':>9}")
    for i in range(pop.n_clients):
        print(
            f"  {i:>3} {p[i]:6.3f} {v_md[i]:9.2e} {v_c[i]:9.2e} "
            f"{q_md[i]:6.3f} {q_c[i]:6.3f} {int(max_draws_bound(plan1)[i]):>9}"
        )
    print(
        f"\n  totals: Var ratio {v_c.sum() / v_md.sum():.3f} (paper: <= 1), "
        f"E[#distinct] {q_md.sum():.2f} -> {q_c.sum():.2f} (paper: improves)"
    )


if __name__ == "__main__":
    main()
