# Adapted from benchmarks/bench_scheduler.py: the same policies, churn, spec,
# parity gate and rows, on a device.
"""Round-scheduler sweep: sync / deadline / overselect under poisson churn.

Two claims are on trial:

1. **Sync parity** — the scheduler hooks must be free when the policy is
   the legacy one: a server with an explicit ``SyncScheduler`` attached
   must train **bit-identically** to one with no scheduler at all (same
   spec, scheduler=None). This is the subsystem's no-regression gate,
   asserted on every invocation.
2. **Straggler grading beats straggler dropping** — under a 30% straggler
   latency model the deadline scheduler keeps harvesting late updates into
   the next round's gradient store (``n_harvested > 0``) instead of
   forgetting slow clients, and overselection keeps rounds full by drawing
   ``m·(1+β)`` up front. Reported per scheduler: time-to-accuracy,
   final accuracy, degraded-round fraction, total late/harvested counts
   and sustained rounds/s.

Run: ``python -m repro_torch.benchmarks.bench_scheduler [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import PAPER_TRAIN, emit, parse_with_device, sync
from repro_torch.fl.experiment import ExperimentSpec, build_dataset, build_experiment

DIM = 16

#: the scheduler policies swept; "sync" is the parity baseline
POLICIES = (
    ("sync", {"name": "sync"}),
    (
        "deadline",
        {
            "name": "deadline",
            "options": {"straggle_frac": 0.3, "harvest_discount": 0.5},
            "track_availability": True,
        },
    ),
    ("overselect", {"name": "overselect", "options": {"beta": 0.5}}),
)

#: mild churn so availability conditioning is exercised alongside lateness
CHURN = {"name": "poisson", "options": {"leave_rate": 0.2, "join_rate": 0.2}}


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
        "population": CHURN,
    }


def _run(spec_dict: dict, dataset, device) -> tuple:
    spec = ExperimentSpec.from_dict(spec_dict)
    with build_experiment(spec, dataset=dataset, device=device) as srv:
        t0 = time.perf_counter()
        hist = srv.run(skip_empty=True)
        sync(device)
        wall = time.perf_counter() - t0
    return hist, wall


def _check_bit_identical(a, b, what: str) -> None:
    identical = len(a.records) == len(b.records) and all(
        ra.train_loss == rb.train_loss
        and ra.test_acc == rb.test_acc
        and np.array_equal(ra.agg_weights, rb.agg_weights)
        for ra, rb in zip(a.records, b.records)
    )
    if not identical:
        raise AssertionError(what)


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    ap.add_argument("--target-acc", type=float, default=0.9)
    args = parse_with_device(ap, argv)

    rounds = 8 if args.smoke else 40
    base = _base_spec(rounds, args.smoke)
    dataset = build_dataset(base["data"])

    # parity gate: no scheduler section at all (the exact legacy path)
    legacy_hist, _ = _run(base, dataset, args.device)
    for label, sched in POLICIES:
        hist, wall = _run({**base, "scheduler": sched}, dataset, args.device)
        if label == "sync":
            _check_bit_identical(
                legacy_hist,
                hist,
                "explicit SyncScheduler history diverged from the "
                "scheduler-free server — the scheduler hooks are not free",
            )
        acc = hist.series("test_acc")
        status = hist.series("round_status")
        hit = np.flatnonzero(np.nan_to_num(acc, nan=-1.0) >= args.target_acc)
        tta = int(hit[0]) + 1 if hit.size else -1
        degraded = float(np.mean(status == "degraded"))
        n_late = int(hist.series("n_late").sum())
        n_harv = int(hist.series("n_harvested").sum())
        rps = len(hist.records) / wall if wall > 0 else float("inf")
        extra = ";parity=bit-identical" if label == "sync" else ""
        if label == "deadline":
            # 30% stragglers over 8+ rounds: the harvest path must fire, or
            # the buffer never reaches the store and slow clients go stale
            if n_late <= 0:
                raise AssertionError("deadline scheduler saw no stragglers")
            if n_harv <= 0:
                raise AssertionError(
                    "deadline scheduler harvested nothing — late updates never "
                    "reached the next round's gradient store"
                )
        finite = acc[np.isfinite(acc)]
        final_acc = float(finite[-1]) if finite.size else float("nan")
        emit(
            f"scheduler/{label}",
            wall * 1e6 / max(len(hist.records), 1),
            f"rounds_to_acc{args.target_acc}={tta};final_acc={final_acc:.4f};"
            f"degraded_frac={degraded:.2f};n_late={n_late};n_harvested={n_harv};"
            f"rounds_per_s={rps:.2f}{extra}",
        )


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
