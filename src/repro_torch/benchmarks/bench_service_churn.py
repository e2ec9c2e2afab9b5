# Adapted from benchmarks/bench_service_churn.py: the same scenarios, spec,
# parity gate and rows, on a device.
"""Continuous-service churn sweep: time-to-accuracy and sustained rounds/s
under client churn and mid-round dropout.

Two claims are on trial:

1. **Zero-churn parity** — the availability/drop-resolution phases must be
   free when nothing churns: the ``static`` cell's History must be
   *bit-identical* to the plain batch loop's (same spec, no population
   process attached). This is the no-regression gate, asserted on every
   invocation.
2. **Graceful degradation** — under increasing churn/dropout the service
   keeps making progress (unbiased over the available set), paying in
   time-to-accuracy rather than in crashes. Reported per scenario:
   rounds-to-target-accuracy, final accuracy, degraded-round fraction and
   sustained rounds/s.

Not in ``run.py``'s ``MODULES``, as in the reference.

Run: ``python -m repro_torch.benchmarks.bench_service_churn [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import PAPER_TRAIN, emit, parse_with_device, sync
from repro_torch.fl.experiment import ExperimentSpec, build_dataset, build_experiment

DIM = 16

#: the ≥3 churn/dropout scenarios swept, mildest to harshest; "static" is
#: the parity baseline (a real process with all-true masks, zero drops)
SCENARIOS = (
    ("static", {"name": "static"}),
    ("dropout10", {"name": "dropout", "options": {"rate": 0.1}}),
    ("dropout30", {"name": "dropout", "options": {"rate": 0.3}}),
    ("poisson", {"name": "poisson", "options": {"leave_rate": 0.3, "join_rate": 0.3}}),
    ("diurnal+drop", {"name": "periodic", "options": {"period": 8, "duty": 0.5, "drop_rate": 0.1}}),
)


def _base_spec(rounds: int, smoke: bool) -> dict:
    data_opts = (
        {"clients_per_class": 2, "train_per_client": 40, "dim": 8, "n_classes": 4, "seed": 0}
        if smoke
        else {"clients_per_class": 10, "dim": DIM, "noise": 1.0, "seed": 0}
    )
    train = dict(PAPER_TRAIN, n_rounds=rounds, seed=0)
    if smoke:
        train.update(n_local_steps=3, batch_size=10)
    return {
        "data": {"name": "by_class_shards", "options": data_opts},
        "sampler": {"name": "algorithm2", "m": 4 if smoke else 10},
        "train": train,
    }


def _run(spec_dict: dict, dataset, device) -> tuple:
    spec = ExperimentSpec.from_dict(spec_dict)
    with build_experiment(spec, dataset=dataset, device=device) as srv:
        t0 = time.perf_counter()
        hist = srv.run(skip_empty=True)
        sync(device)
        wall = time.perf_counter() - t0
    return hist, wall


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    ap.add_argument("--target-acc", type=float, default=0.9)
    args = parse_with_device(ap, argv)

    rounds = 8 if args.smoke else 40
    base = _base_spec(rounds, args.smoke)
    dataset = build_dataset(base["data"])

    # parity gate: the batch loop (no population process at all) vs the
    # service path with an explicit static process — bit-identical histories
    batch_hist, _ = _run(base, dataset, args.device)
    for label, pop in SCENARIOS:
        hist, wall = _run({**base, "population": pop}, dataset, args.device)
        acc = hist.series("test_acc")
        status = hist.series("round_status")
        hit = np.flatnonzero(np.nan_to_num(acc, nan=-1.0) >= args.target_acc)
        tta = int(hit[0]) + 1 if hit.size else -1
        degraded = float(np.mean(status == "degraded"))
        rps = len(hist.records) / wall if wall > 0 else float("inf")
        extra = ""
        if label == "static":
            a, b = batch_hist, hist
            identical = len(a.records) == len(b.records) and all(
                ra.train_loss == rb.train_loss
                and ra.test_acc == rb.test_acc
                and np.array_equal(ra.agg_weights, rb.agg_weights)
                for ra, rb in zip(a.records, b.records)
            )
            if not identical:
                raise AssertionError(
                    "zero-churn service history diverged from the batch loop — "
                    "the availability phases are not free"
                )
            extra = ";parity=bit-identical"
        emit(
            f"service_churn/{label}",
            wall * 1e6 / max(len(hist.records), 1),
            f"rounds_to_acc{args.target_acc}={tta};final_acc={float(acc[np.isfinite(acc)][-1]):.4f};"
            f"degraded_frac={degraded:.2f};rounds_per_s={rps:.2f}{extra}",
        )


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
