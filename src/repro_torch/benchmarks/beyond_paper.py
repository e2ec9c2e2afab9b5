# Adapted from benchmarks/beyond_paper.py: the same sweeps and plan check,
# run on a device; the check demands equal plans, not allclose.
"""Beyond-paper extensions (recorded separately from the faithful repro):

1. stale-aware Algorithm 2 — decay representative gradients by γ per round
   so long-unsampled clients return to the cold-start cluster (the paper
   clusters on arbitrarily stale similarity). Compared at γ ∈ {1.0 (paper),
   0.8, 0.5} under a small m (staleness is worst when few clients refresh
   per round) — a one-axis ``SweepSpec`` over ``staleness_decay`` through
   the shared campaign runner.
2. device-offloaded similarity — Algorithm 2 with the similarity kernel as
   its distance backend (``distance_fn="auto"``: the kernel on the card,
   its plain version on the CPU), asserting a plan identical, bit for bit,
   to the f64 numpy host path's. The two backends differ by one spec option
   (``distance_fn``).
3. client churn — the paper assumes everyone answers every round; the
   continuous-service layer (``repro_torch.fl.population``) relaxes that.
   One ``SweepSpec`` axis over whole ``population`` sections compares
   clustered sampling under a fixed fleet, Poisson arrival/departure churn,
   and 20% mid-round dropout — how much availability-conditioned
   re-normalization costs in final loss/accuracy at matched rounds.

Run: ``python -m repro_torch.benchmarks.beyond_paper [--device cpu]``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import PAPER_TRAIN, device_from_argv, emit, run_sweep_emit
from repro_torch.core import validate_plan
from repro_torch.fl.experiment import DataSpec, build_dataset, build_sampler

DIM = 32
ROUNDS = 12
PLAN_DIM = 128  # width of the plan check's random gradients

DATA = {"name": "dirichlet_labels", "options": {"alpha": 0.01, "dim": DIM, "noise": 2.5}}

# NOTE: the decay must be paired with a magnitude-sensitive measure —
# arccos is scale-invariant, so uniformly shrinking stale vectors would
# not change any angle (verified: identical runs under arccos). L2 sees
# the decayed vectors drift toward the zero / cold-start cluster.
SWEEP_STALENESS = {
    "base": {
        "data": DATA,
        "sampler": {"name": "algorithm2", "m": 5, "options": {"measure": "l2"}},
        "train": {"n_rounds": ROUNDS, **PAPER_TRAIN},
    },
    "axes": {"sampler.options.staleness_decay": [1.0, 0.8, 0.5]},
    "root_seed": 4,
}

# churn axis: whole population sections as axis values (the sweep layer
# treats a section-level path as a swap of the entire dict)
SWEEP_CHURN = {
    "base": {
        "data": DATA,
        "sampler": {"name": "algorithm2", "m": 5},
        "train": {"n_rounds": ROUNDS, **PAPER_TRAIN},
    },
    "axes": {
        "population": [
            {"name": "static"},
            {"name": "poisson", "options": {"join_rate": 0.3, "leave_rate": 0.3}},
            {"name": "dropout", "options": {"rate": 0.2}},
        ]
    },
    "root_seed": 4,
}


#: (sweep, label, stats) in the order ``main`` runs them
SWEEPS = (
    (SWEEP_STALENESS, "beyond/staleness", None),
    (SWEEP_CHURN, "beyond/churn", None),
)


def plan_check(d: int = PLAN_DIM, *, device="cuda", backend: str = "auto"):
    """Algorithm 2's plan from the same random (n, d) gradients through the
    f64 numpy host measure and through ``backend`` (a ``distance_fn`` that
    reaches the similarity op) on ``device``. Returns (identical, host
    plan, device plan): identical means ``r`` and the urns' tokens equal bit
    for bit."""
    ds = build_dataset(DataSpec.from_dict(DATA))
    pop = ds.population
    rng = np.random.default_rng(0)
    G = rng.normal(size=(pop.n_clients, d))
    host, dev = (
        build_sampler(
            {"name": "algorithm2", "m": 10, "options": {"distance_fn": name}},
            pop,
            update_dim=d,
            device=device,
        )
        for name in ("numpy", backend)
    )
    try:
        ids = np.arange(pop.n_clients)
        host.observe_updates(ids, G)
        dev.observe_updates(ids, G)
        validate_plan(dev.plan, pop)
        same = bool(np.array_equal(host.plan.r, dev.plan.r)
                    and np.array_equal(host.plan.r_tokens, dev.plan.r_tokens))
        return same, host.plan, dev.plan
    finally:
        host.close()
        dev.close()


def main(argv: "list[str] | None" = None) -> None:
    device = device_from_argv(__doc__.splitlines()[0], argv)
    for sweep, label, stats in SWEEPS:
        run_sweep_emit(sweep, label, stats=stats, device=device)

    # kernel-backed similarity must produce the identical plan
    same, _, _ = plan_check(device=device)
    emit("beyond/pallas_similarity_plan_identical", 0.0, f"identical={same}")


if __name__ == "__main__":
    main()
