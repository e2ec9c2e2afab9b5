# Adapted from benchmarks/ablations.py: the same sweeps, run on a device.
"""Appendix D ablations: similarity measure (D.2), local work N and number of
sampled clients m (D.4), FedProx regularization (D.5).

Each ablation axis is a ``SweepSpec`` through the shared campaign runner
(``repro_torch.fl.sweep``): the varied knob is a dotted-path axis into the
base spec, nothing is hand-wired. Single replicate per cell (the ablations
are qualitative); the replicate's data/train seeds still derive from the
sweep's ``root_seed`` so every ablation shares one partition, as in the
appendix. D.2's arccos and l2 measures reach the similarity kernel's Gram,
l1 its L1 sums; every round's aggregation runs the aggregate kernel.

Run: ``python -m repro_torch.benchmarks.ablations [--device cpu]``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import PAPER_TRAIN, device_from_argv, run_sweep_emit

DIM = 32
ROUNDS = 12

DATA = {"name": "dirichlet_labels", "options": {"alpha": 0.01, "dim": DIM, "noise": 2.5}}


def _base(sampler: dict, **train_overrides) -> dict:
    return {
        "data": DATA,
        "sampler": sampler,
        "train": {"n_rounds": ROUNDS, **PAPER_TRAIN, **train_overrides},
    }


#: D.2 — similarity measures are equivalent in practice
SWEEP_D2 = {
    "base": _base({"name": "algorithm2", "m": 10}),
    "axes": {"sampler.options.measure": ["arccos", "l2", "l1"]},
    "root_seed": 3,
}

#: D.4 — influence of N (local steps) and m (sampled clients)
SWEEP_D4_N = {
    "base": _base({"name": "md", "m": 10}),
    "axes": {"train.n_local_steps": [5, 20], "sampler.name": ["md", "algorithm2"]},
    "root_seed": 3,
}
SWEEP_D4_M = {
    "base": _base({"name": "md", "m": 10}),
    "axes": {"sampler.m": [5, 20], "sampler.name": ["md", "algorithm2"]},
    "root_seed": 3,
}

#: D.5 — FedProx (mu = 0.1): clustered sampling still helps
SWEEP_D5 = {
    "base": _base({"name": "md", "m": 10}, fedprox_mu=0.1),
    "axes": {"sampler.name": ["md", "algorithm2"]},
    "root_seed": 3,
}

#: (sweep, label, stats) in the order ``main`` runs them; the labels are
#: also the per-sweep store keys under $BENCH_SWEEP_STORE, so the two D.4
#: sub-sweeps must not share one
SWEEPS = (
    (SWEEP_D2, "ablation_D2", None),
    (SWEEP_D4_N, "ablation_D4_N", {"loss": "final_loss"}),
    (SWEEP_D4_M, "ablation_D4_m", {"loss": "final_loss"}),
    (SWEEP_D5, "ablation_D5_fedprox", {"loss": "final_loss"}),
)


def main(argv: "list[str] | None" = None) -> None:
    device = device_from_argv(__doc__.splitlines()[0], argv)
    for sweep, label, stats in SWEEPS:
        run_sweep_emit(sweep, label, stats=stats, device=device)


if __name__ == "__main__":
    main()
