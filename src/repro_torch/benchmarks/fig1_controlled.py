# Adapted from benchmarks/fig1_controlled.py: the same SWEEP, run on a device.
"""Figure 1 reproduction: controlled 100-client / 10-class setting.

MD vs Algorithm 1 vs Algorithm 2 vs 'target' oracle on the paper's
controlled partition (each client one class, 10 clients per class,
balanced sizes, m = 10). Reports mean±std final rolling loss, accuracy
and the per-round class representativity over N_SEEDS paired replicates —
the paper's key qualitative claims: clustered sampling always aggregates
10 distinct clients and Algorithm 2 approaches 'target'.

The whole figure is ONE campaign: a ``SweepSpec`` whose single axis is the
sampler section, run through the shared resumable runner
(``repro_torch.fl.sweep``) — per-replicate data/sampler/train seeds derive from
``SeedSequence(root_seed)`` and are shared across the four schemes, so
the comparison is paired. Adding a scheme is one more dict.

Run: ``python -m repro_torch.benchmarks.fig1_controlled [--device cpu]``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import PAPER_TRAIN, device_from_argv, run_sweep_emit

ROUNDS = 25
DIM = 32
N_SEEDS = 2

DATA = {
    "name": "by_class_shards",
    "options": {"dim": DIM, "noise": 2.5, "train_per_client": 200, "test_per_client": 30},
}

SWEEP = {
    "base": {
        "data": DATA,
        "sampler": {"name": "md", "m": 10},
        "train": {"n_rounds": ROUNDS, **PAPER_TRAIN},
    },
    "axes": {
        "sampler": [
            {"name": "md", "m": 10},
            {"name": "algorithm1", "m": 10},
            {"name": "algorithm2", "m": 10},
            {
                "name": "target",
                "m": 10,
                "options": {"groups": [list(range(i * 10, (i + 1) * 10)) for i in range(10)]},
            },
        ],
    },
    "n_seeds": N_SEEDS,
    "root_seed": 1,
}

STATS = {
    "loss": "final_loss",
    "acc": "final_acc",
    "classes": "mean_distinct_classes",
    "clients": "mean_distinct_clients",
}


def main(argv: "list[str] | None" = None) -> None:
    device = device_from_argv(__doc__.splitlines()[0], argv)
    run_sweep_emit(SWEEP, "fig1", stats=STATS, device=device)


if __name__ == "__main__":
    main()
