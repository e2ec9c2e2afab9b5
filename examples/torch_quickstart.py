"""Quickstart on the PyTorch port: clustered sampling vs MD sampling.

Reproduces the paper's controlled experiment (Fig. 1) at reduced scale:
100 clients, each owning ONE class of a 10-class problem, server samples
m=10 per round. Watch the per-round class representativity — MD sampling
aggregates 6-8 distinct classes per round, clustered sampling always 10.

The comparison is a scenario matrix of declarative experiment specs
(``repro_torch.fl.experiment``): each scheme is one dict,
``build_experiment`` resolves it through the sampler registry, and the
``with`` block owns the sampler's background resources. As
``examples/quickstart.py``, plus ``--device`` (the card by default;
``--device cpu`` runs the kernels' plain versions).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fl.experiment import DataSpec, build_dataset, build_experiment

ROUNDS = 15

DATA = {
    "name": "by_class_shards",
    "options": {"dim": 32, "noise": 2.0, "train_per_client": 200, "test_per_client": 30, "seed": 0},
}

SCENARIOS = {
    "MD sampling (Li et al. 2018)": {"name": "md", "m": 10},
    "Clustered / Algorithm 1     ": {"name": "algorithm1", "m": 10},
    "Clustered / Algorithm 2     ": {"name": "algorithm2", "m": 10},
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device the runs use (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    ds = build_dataset(DataSpec.from_dict(DATA))  # one partition, three schemes
    print(f"{'sampler':30s} {'final loss':>10s} {'test acc':>9s} {'classes/round':>14s}")
    for name, sampler in SCENARIOS.items():
        spec = {
            "data": DATA,
            "sampler": sampler,
            "train": {"n_rounds": ROUNDS, "n_local_steps": 10, "batch_size": 50, "lr": 0.05, "seed": 0},
        }
        with build_experiment(spec, dataset=ds, device=args.device) as srv:
            hist = srv.run()
        print(
            f"{name:30s} {hist.rolling('train_loss', 5)[-1]:10.4f} "
            f"{np.nanmax(hist.series('test_acc')[-3:]):9.3f} "
            f"{hist.series('n_distinct_classes').mean():14.2f}"
        )
    print("\nClustered sampling: same communication budget, strictly better "
          "representativity (Proposition 1 + Section 3.2 of the paper).")


if __name__ == "__main__":
    main()
