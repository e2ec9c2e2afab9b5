# Adapted from benchmarks/run.py: the same doors (--spec, --sweep, --list and
# the full run) over the port's runners and registries, on a device.
"""Benchmark harness — one module per paper table/figure, on the port.

``--spec '<json>'`` (inline or a file path) instead runs ONE declarative
experiment through ``repro_torch.fl.experiment`` and streams its per-round
records — the scenario door for comparison studies.

``--sweep '<json>'`` runs a whole campaign (``repro_torch.fl.sweep.SweepSpec``:
grid × seeds) into a resumable RunStore (``--store DIR``, ephemeral when
omitted; ``--workers k`` fans independent cells over a process pool) and
collates it into figure-ready CSVs. ``--list`` prints every registered
sampler / engine / dataset / population / clusterer / sketcher / scheduler
and the port's benchmark modules — the discoverability door for the spec
and sweep layers. ``--device`` (default ``cuda``) is where every run goes;
``cpu`` runs the kernels' plain PyTorch versions.

Prints ``name,us_per_call,derived`` CSV rows:
  table_variance       — Section 3.2 / Appendix B statistics (theory vs MC)
  bench_sampler_cost   — Theorems 3/4 complexity scaling
  bench_round_engine   — batched round engine vs compat loop
  bench_engine_sharded — mesh-sharded engine: per-device staged bytes sweep
  bench_async_planner  — async re-clustering planner + similarity over d
  bench_store_scale    — sketched GradientStore: bytes/scatter/rebuild at scale
  bench_scheduler      — round schedulers (sync/deadline/overselect) under churn
  bench_fl_collectives — communication accounting (paper's motivation)
  bench_kernels        — the CUDA kernels beside their plain versions
  bench_dryrun_roofline — the dry-run's roofline terms per (arch × shape × mesh)
  fig1_controlled      — Figure 1 (controlled MNIST-style setting)
  fig2_dirichlet       — Figure 2 (Dirichlet-α heterogeneity sweep)
  scheme_race          — every registered selection scheme raced on one sweep
  ablations            — Appendix D.2/D.4/D.5
  beyond_paper         — staleness decay, client churn, device-vs-host plans

``bench_service_churn`` runs on its own, as in the reference.

Run: ``python -m repro_torch.benchmarks.run [--list | --spec JSON | --sweep JSON] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile
import time
import traceback

from repro_torch.benchmarks import (
    ablations,
    bench_async_planner,
    bench_dryrun_roofline,
    bench_engine_sharded,
    bench_fl_collectives,
    bench_kernels,
    bench_round_engine,
    bench_sampler_cost,
    bench_scheduler,
    bench_store_scale,
    beyond_paper,
    fig1_controlled,
    fig2_dirichlet,
    scheme_race,
    table_variance,
)
from repro_torch.device import resolve_device

MODULES = [
    ("table_variance", table_variance),
    ("bench_sampler_cost", bench_sampler_cost),
    ("bench_round_engine", bench_round_engine),
    ("bench_engine_sharded", bench_engine_sharded),
    ("bench_async_planner", bench_async_planner),
    ("bench_store_scale", bench_store_scale),
    ("bench_scheduler", bench_scheduler),
    ("bench_fl_collectives", bench_fl_collectives),
    ("bench_kernels", bench_kernels),
    ("bench_dryrun_roofline", bench_dryrun_roofline),
    ("fig1_controlled", fig1_controlled),
    ("fig2_dirichlet", fig2_dirichlet),
    ("scheme_race", scheme_race),
    ("ablations", ablations),
    ("beyond_paper", beyond_paper),
]


def run_one_spec(spec_arg: str, *, device="cuda") -> None:
    """Run a single experiment spec (inline JSON or a path to a JSON file)."""
    from repro_torch.benchmarks.common import emit, run_spec
    from repro_torch.fl.experiment import ExperimentSpec

    spec = ExperimentSpec.from_arg(spec_arg)
    label = f"spec/{spec.data.name}/{spec.sampler.name}"
    print("name,us_per_call,derived")
    t0 = time.perf_counter()
    res = run_spec(  # per-round records stream through the server's hook
        spec,
        on_round=lambda rec: emit(
            f"{label}/round={rec.round}", 0.0,
            f"loss={rec.train_loss:.4f};plan_v={rec.plan_version};"
            f"lag={rec.plan_lag_rounds}",
        ),
        device=device,
    )
    us = (time.perf_counter() - t0) * 1e6 / spec.train.n_rounds
    emit(label, us, f"loss={res['final_loss']:.4f};acc={res['final_acc']:.3f}")


def run_one_sweep(sweep_arg: str, store_dir: "str | None", workers: int, *, device="cuda") -> None:
    """Run a whole campaign through the resumable sweep runner + collate."""
    from repro_torch.benchmarks.common import emit
    from repro_torch.fl.sweep import SweepSpec, cell_group_label, run_sweep, write_collated

    sweep = SweepSpec.from_arg(sweep_arg)
    print("name,us_per_call,derived")

    def on_cell(cell, status, summary, dt):
        label = cell_group_label(cell.overrides) or "base"
        rounds = max(cell.spec.train.n_rounds, 1)
        emit(
            f"sweep/{label}/seed={cell.seed_index}",
            dt * 1e6 / rounds,
            f"status={status};loss={summary['final_loss']:.4f}",
        )

    with contextlib.ExitStack() as stack:
        root = store_dir or stack.enter_context(tempfile.TemporaryDirectory(prefix="sweep-"))
        store = run_sweep(sweep, root, workers=workers, on_cell=on_cell, device=device)
        cells_csv, summary_csv = write_collated(store)
        print(f"# collated: {cells_csv}")
        print(f"# collated: {summary_csv}")


def list_registered() -> None:
    """Print every registered name the spec/sweep doors can reach."""
    from repro_torch.core.clustering.backends import CLUSTERERS
    from repro_torch.core.samplers import SAMPLERS
    from repro_torch.fl.engine import ENGINES
    from repro_torch.fl.experiment import DATASETS
    from repro_torch.fl.population import POPULATIONS
    from repro_torch.fl.scheduler import SCHEDULERS
    from repro_torch.kernels.sketch.ops import SKETCHERS

    print("samplers:    " + " ".join(SAMPLERS.names()))
    print("engines:     " + " ".join(ENGINES.names()))
    print("datasets:    " + " ".join(DATASETS.names()))
    print("populations: " + " ".join(POPULATIONS.names()))
    print("clusterers:  " + " ".join(CLUSTERERS.names()))
    print("sketchers:   " + " ".join(SKETCHERS.names()))
    print("schedulers:  " + " ".join(SCHEDULERS.names()))
    print("benchmarks:  " + " ".join(name for name, _ in MODULES))


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--spec", default=None,
        help="experiment-spec JSON (inline or a file path): run that one "
        "declarative scenario instead of the full benchmark sweep",
    )
    ap.add_argument(
        "--sweep", default=None,
        help="sweep-spec JSON (inline or a file path): run a whole campaign "
        "(grid x seeds) through the resumable RunStore and collate it",
    )
    ap.add_argument(
        "--store", default=None,
        help="RunStore directory for --sweep (resumable; ephemeral if omitted)",
    )
    ap.add_argument(
        "--workers", type=int, default=1,
        help="process-pool fan-out for independent --sweep cells",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="print registered samplers / engines / datasets / populations / "
        "clusterers / sketchers / schedulers / benchmark modules",
    )
    ap.add_argument("--device", default="cuda",
                    help="device the runs use (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.list:
        list_registered()
        return
    if args.spec and args.sweep:
        ap.error("--spec and --sweep are mutually exclusive")
    resolve_device(args.device)  # raise before any work when CUDA is absent
    if args.spec:
        run_one_spec(args.spec, device=args.device)
        return
    if args.sweep:
        run_one_sweep(args.sweep, args.store, args.workers, device=args.device)
        return
    print("name,us_per_call,derived")
    failures = []
    for name, mod in MODULES:
        t0 = time.time()
        try:
            mod.main(["--device", args.device])
        except Exception:  # noqa: BLE001
            failures.append(name)
            traceback.print_exc()
        print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)
    if failures:
        print(f"# FAILED: {failures}", file=sys.stderr)
        raise SystemExit(1)
    print("# all benchmarks complete")


if __name__ == "__main__":
    main()
