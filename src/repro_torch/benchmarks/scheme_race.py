# Adapted from benchmarks/scheme_race.py: the same campaign and parity gate,
# run on a device.
"""Scheme race: every registered client-selection scheme on one campaign.

ONE ``SweepSpec`` with the sampler scheme as a grid axis — the paper's
algorithms (``md``, ``uniform``, ``algorithm2``) raced head-to-head against
the scheme zoo (``stratified``, ``importance``, ``dp_stratified``,
``hybrid``) over paired seed replicates. The collated ``summary.csv``
carries mean±std for every :data:`repro_torch.fl.sweep.SUMMARY_STATS` column,
including the race's two quality axes:

  - ``rounds_to_acc``  — time-to-accuracy (first round reaching
    ``ACC_TARGET``; censored runs report the horizon)
  - ``agg_weight_var`` — Σ_i Var_t(ω_i), the variance the clustered /
    stratified schemes exist to shrink at fixed E[ω_i] = p_i

``--smoke`` shrinks the grid to 2 schemes × 2 seeds; ``--store DIR`` makes
the campaign resumable (re-invoking on the same store skips completed
cells). ``--device`` (default ``cuda``) is where every cell runs; pass
``cpu`` for the plain PyTorch versions. ``--parity`` instead runs
the md-vs-importance gate: ``importance`` with ``mix = 1.0`` must produce a
bit-identical training history to ``md`` on the same seed (plan telemetry
normalized out — importance runs a PlanService, md does not).

Run: ``python -m repro_torch.benchmarks.scheme_race [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import tempfile

from repro_torch.benchmarks.common import PAPER_TRAIN, emit
from repro_torch.device import resolve_device

SCHEMES = (
    "md",
    "uniform",
    "algorithm2",
    "stratified",
    "importance",
    "dp_stratified",
    "hybrid",
)
SMOKE_SCHEMES = ("md", "stratified")

#: mean±std columns emitted per grid point (short label -> summary stat)
RACE_STATS = {
    "loss": "final_loss",
    "acc": "final_acc",
    "tta": "rounds_to_acc",
    "wvar": "agg_weight_var",
}


def race_sweep(*, smoke: bool, n_seeds: "int | None" = None) -> dict:
    """The campaign spec: sampler scheme as a grid axis, paired seeds."""
    if smoke:
        return {
            "base": {
                "data": {
                    "name": "by_class_shards",
                    "options": {"n_classes": 4, "clients_per_class": 2, "dim": 8,
                                 "train_per_client": 40, "test_per_client": 8},
                },
                "sampler": {"name": "md", "m": 4},
                "train": {"n_rounds": 3, "n_local_steps": 2, "batch_size": 10,
                           "hidden": [16]},
            },
            "axes": {"sampler.name": list(SMOKE_SCHEMES)},
            "n_seeds": 2 if n_seeds is None else n_seeds,
            "root_seed": 11,
        }
    return {
        "base": {
            "data": {
                "name": "by_class_shards",
                "options": {"n_classes": 10, "clients_per_class": 10, "dim": 32,
                             "train_per_client": 100, "test_per_client": 20},
            },
            "sampler": {"name": "md", "m": 10},
            "train": {"n_rounds": 20, **PAPER_TRAIN},
        },
        "axes": {"sampler.name": list(SCHEMES)},
        "n_seeds": 3 if n_seeds is None else n_seeds,
        "root_seed": 11,
    }


def run_race(
    sweep: dict, store_dir: "str | None", workers: int = 1, *, device="cuda"
) -> list[dict]:
    """Run the race on ``device`` into a (resumable) RunStore; emit cells +
    mean±std rows.

    Unlike ``run_sweep_emit`` this also emits one ``status=`` row per cell,
    so a resumed invocation is observable (``status=skipped``).
    """
    from repro_torch.fl.sweep import SweepSpec, cell_group_label, collate, run_sweep, write_collated

    spec = SweepSpec.from_dict(sweep)
    with contextlib.ExitStack() as stack:
        root = store_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="scheme-race-")
        )

        def on_cell(cell, status, summary, dt):
            rounds = max(cell.spec.train.n_rounds, 1)
            emit(
                f"scheme_race/{cell_group_label(cell.overrides)}/seed={cell.seed_index}",
                dt * 1e6 / rounds,
                f"status={status};loss={summary['final_loss']:.4f}",
            )

        store = run_sweep(spec, root, workers=workers, on_cell=on_cell, device=device)
        cell_rows, agg_rows = collate(store)
        cells_csv, summary_csv = write_collated(store, rows=(cell_rows, agg_rows))
        print(f"# collated: {cells_csv}")
        print(f"# collated: {summary_csv}")
    for row in agg_rows:
        derived = ";".join(
            f"{short}={row[f'{stat}_mean']:.4f}±{row[f'{stat}_std']:.4f}"
            for short, stat in RACE_STATS.items()
        )
        emit(
            f"scheme_race/scheme={row['sampler.name']}", 0.0,
            f"{derived};seeds={row['n_seeds']}",
        )
    return agg_rows


# -- md vs importance(mix=1.0) parity gate ---------------------------------
PARITY_SPEC = {
    "data": {"name": "by_class_shards",
             "options": {"n_classes": 4, "clients_per_class": 2, "dim": 8,
                          "train_per_client": 40, "test_per_client": 8, "seed": 0}},
    "train": {"n_rounds": 5, "n_local_steps": 2, "batch_size": 10,
               "hidden": [16], "seed": 1},
}
#: importance runs a PlanService (md does not) — its plan telemetry columns
#: are structural, not behavioral, and are normalized out of the comparison
PLAN_TELEMETRY = ("plan_version", "plan_lag_rounds", "plan_build_ms", "plan_drift")


def check_md_importance_parity(seed: int = 7, *, device="cuda") -> None:
    """``importance`` at ``mix=1.0`` proposes q = p exactly and its weight
    correction is elementwise 1.0, so the full training history on
    ``device`` must be bit-identical to ``md`` on the same seed. SystemExit
    on drift."""
    from repro_torch.fl.experiment import build_experiment

    def history(sampler: dict) -> str:
        with build_experiment({**PARITY_SPEC, "sampler": sampler}, device=device) as srv:
            recs = json.loads(srv.run().to_json())
        for r in recs:
            for f in PLAN_TELEMETRY:
                r.pop(f, None)
        return json.dumps(recs, sort_keys=True)

    md = history({"name": "md", "m": 4, "seed": seed})
    imp = history({"name": "importance", "m": 4, "seed": seed,
                   "options": {"mix": 1.0}})
    if md != imp:
        raise SystemExit(
            "scheme_race parity gate FAILED: importance(mix=1.0) history "
            "diverged from md — the size-proportional degenerate case must "
            "be bit-identical"
        )
    emit("scheme_race/parity/md_vs_importance", 0.0, "bit_identical=1")


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="2 schemes x 2 seeds tiny grid")
    ap.add_argument("--seeds", type=int, default=None,
                    help="override the replicate count")
    ap.add_argument("--store", default=None,
                    help="RunStore directory (resumable; ephemeral if omitted)")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool fan-out for independent cells")
    ap.add_argument("--parity", action="store_true",
                    help="run only the md-vs-importance(mix=1.0) bit-parity gate")
    ap.add_argument("--device", default="cuda",
                    help="device the runs use (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raise before any work when CUDA is absent

    if args.parity:
        check_md_importance_parity(device=args.device)
        return
    run_race(race_sweep(smoke=args.smoke, n_seeds=args.seeds),
             args.store, workers=args.workers, device=args.device)


if __name__ == "__main__":
    main()
