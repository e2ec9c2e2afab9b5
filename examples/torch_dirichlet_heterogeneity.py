"""Heterogeneity study (paper Fig. 2) on the PyTorch port: Dirichlet(α)
non-iid partitions on the unbalanced 100-client profile (10×100 … 10×1000
samples). The smaller α, the bigger clustered sampling's edge over MD
sampling.

Each run is one declarative experiment spec; the per-round progress line
streams through the server's ``on_round`` telemetry hook. As
``examples/dirichlet_heterogeneity.py``, plus ``--device`` (the card by
default; ``--device cpu`` runs the kernels' plain versions).

Run:  PYTHONPATH=src python examples/torch_dirichlet_heterogeneity.py [--alpha 0.01] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fl.experiment import DataSpec, build_dataset, build_experiment


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--verbose", action="store_true", help="stream per-round records")
    ap.add_argument("--device", default="cuda",
                    help="device the runs use (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    data = {"name": "dirichlet_labels", "options": {"alpha": args.alpha, "dim": 32, "noise": 2.0, "seed": 0}}
    ds = build_dataset(DataSpec.from_dict(data))
    pop = ds.population

    print(f"Dirichlet(α={args.alpha}) — {ds.n_clients} clients, "
          f"{pop.total_samples} samples, m=10 sampled/round")
    for name, sampler in (("MD", {"name": "md", "m": 10}),
                          ("Clustered-Alg2", {"name": "algorithm2", "m": 10})):
        spec = {
            "data": data,
            "sampler": sampler,
            "train": {"n_rounds": args.rounds, "n_local_steps": 10, "batch_size": 50, "lr": 0.05, "seed": 0},
        }
        on_round = (
            (lambda rec: print(f"    round {rec.round:3d}  loss {rec.train_loss:.4f}"))
            if args.verbose else None
        )
        with build_experiment(spec, dataset=ds, device=args.device) as srv:
            hist = srv.run(on_round=on_round)
        losses = hist.rolling("train_loss", 5)
        print(f"  {name:15s} loss: {losses[0]:.4f} -> {losses[-1]:.4f}   "
              f"acc: {np.nanmax(hist.series('test_acc')[-3:]):.3f}   "
              f"distinct clients/round: {hist.series('n_distinct_clients').mean():.2f}")


if __name__ == "__main__":
    main()
