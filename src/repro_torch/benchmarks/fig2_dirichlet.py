# Adapted from benchmarks/fig2_dirichlet.py: the same SWEEP, run on a device.
"""Figure 2 reproduction: Dirichlet(α) heterogeneity sweep on the paper's
unbalanced 100-client profile. The paper's claim: the smaller α (more
heterogeneous), the larger the improvement of clustered sampling over MD.

The figure is ONE campaign — a ``SweepSpec`` over α × sampler with
N_SEEDS paired replicates (``repro_torch.fl.sweep``); the clustered gain
per α is derived from the collated mean final losses.

Run: ``python -m repro_torch.benchmarks.fig2_dirichlet [--device cpu]``.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import PAPER_TRAIN, device_from_argv, emit, run_sweep_emit

ALPHAS = (0.001, 0.01, 0.1, 10.0)
ROUNDS = 20
DIM = 32
N_SEEDS = 2

SWEEP = {
    "base": {
        "data": {"name": "dirichlet_labels", "options": {"alpha": 0.001, "dim": DIM, "noise": 2.5}},
        "sampler": {"name": "md", "m": 10},
        "train": {"n_rounds": ROUNDS, **PAPER_TRAIN},
    },
    "axes": {
        "data.options.alpha": list(ALPHAS),
        "sampler.name": ["md", "algorithm2"],
    },
    "n_seeds": N_SEEDS,
    "root_seed": 2,
}


def main(argv: "list[str] | None" = None) -> None:
    device = device_from_argv(__doc__.splitlines()[0], argv)
    agg = run_sweep_emit(SWEEP, "fig2", device=device)
    for alpha in ALPHAS:
        rows = {
            r["sampler.name"]: r for r in agg if r["data.options.alpha"] == str(alpha)
        }
        gain = rows["md"]["final_loss_mean"] - rows["algorithm2"]["final_loss_mean"]
        emit(f"fig2/alpha={alpha}/clustered_gain", 0.0, f"loss_delta={gain:.4f}")


if __name__ == "__main__":
    main()
