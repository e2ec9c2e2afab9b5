# Adapted from benchmarks/table_variance.py: the same rows, Algorithm 2 on a
# device.
"""Section 3.2 / Appendix B statistics table: aggregation-weight variance and
inclusion probability, theory vs Monte-Carlo, MD vs Algorithms 1/2.

Quantifies the paper's two theorems (eq. 17 variance reduction, eq. 23
inclusion-probability improvement) on the unbalanced CIFAR profile, plus
the max-draws bound (floor(m p_i) + 2) and the Section-6 distinct-clients
statistic (~63% for MD in the controlled setting, 100% for clustered).

Run: ``python -m repro_torch.benchmarks.table_variance [--device cpu]``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import device_from_argv, emit, timed
from repro_torch.core import ClientPopulation, max_draws_bound
from repro_torch.core.statistics import (
    clustered_inclusion_probability,
    clustered_weight_variance,
    md_inclusion_probability,
    md_prob_all_distinct,
    md_weight_variance,
)

PROFILE = np.concatenate(
    [np.full(10, 100), np.full(30, 250), np.full(30, 500), np.full(20, 750), np.full(10, 1000)]
)


def main(argv: "list[str] | None" = None) -> None:
    from repro_torch.fl.experiment import build_sampler

    device = device_from_argv(__doc__.splitlines()[0], argv)
    pop = ClientPopulation(PROFILE)
    m, T = 10, 3000
    p = pop.importances

    samplers = {
        name: build_sampler({"name": name, "m": m, "seed": 0}, pop, update_dim=16, device=device)
        for name in ("md", "algorithm1", "algorithm2")
    }
    v_md_theory = md_weight_variance(p, m)
    q_md_theory = md_inclusion_probability(p, m)

    for name, s in samplers.items():
        us, _ = timed(lambda: s.sample(0), repeats=50)
        ws = np.stack([s.sample(t).agg_weights for t in range(T)])
        emp_var = ws.var(axis=0).mean()
        emp_inc = (ws > 0).mean(axis=0).mean()
        if name == "md":
            th_var, th_inc = v_md_theory.mean(), q_md_theory.mean()
        else:
            th_var = clustered_weight_variance(s.plan).mean()
            th_inc = clustered_inclusion_probability(s.plan).mean()
        emit(
            f"variance_table/{name}",
            us,
            f"var_mc={emp_var:.3e};var_theory={th_var:.3e};"
            f"incl_mc={emp_inc:.4f};incl_theory={th_inc:.4f};"
            f"var_vs_md={th_var / v_md_theory.mean():.3f}",
        )

    # max draws bound
    for name in ("algorithm1", "algorithm2"):
        s = samplers[name]
        bound = np.floor(m * p) + 2
        emit(
            f"variance_table/{name}_max_draws",
            0.0,
            f"max_support={int(max_draws_bound(s.plan).max())};bound={int(bound.max())}",
        )

    # distinct-clients statistic in the controlled balanced setting
    bal = ClientPopulation(np.full(100, 500))
    emit(
        "variance_table/md_prob_all_distinct",
        0.0,
        f"theory={md_prob_all_distinct(np.full(100, 0.01), m):.4f};paper=0.63",
    )
    s1 = build_sampler({"name": "algorithm1", "m": m, "seed": 0}, bal)
    distinct = np.mean([len(s1.sample(t).unique_clients) == m for t in range(500)])
    emit("variance_table/algorithm1_all_distinct_balanced", 0.0, f"mc={distinct:.3f};paper=1.0")
    for s in (*samplers.values(), s1):
        s.close()


if __name__ == "__main__":
    main()
