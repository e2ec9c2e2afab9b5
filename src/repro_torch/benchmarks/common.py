# Adapted from benchmarks/common.py: emit, timed, PAPER_TRAIN, run_spec and
# run_sweep_emit, with a device argument; timed waits for the device.
"""Shared benchmark helpers: timed CSV rows + spec/sweep-driven FL runs."""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch

from repro_torch.device import resolve_device

ROWS: list[tuple[str, float, str]] = []

#: train-hyperparameter block shared by the paper-figure scenario matrices
#: (the paper's N=10 local steps, B=50, lr=0.05 on the 1x50 MLP). Seeds are
#: NOT pinned here: the sweep layer derives per-replicate data/sampler/train
#: seeds from SeedSequence(root_seed), so "variance" comparisons never share
#: one stream across replicates (they *do* share streams across schemes of
#: the same replicate — paired comparisons, as in the paper's figures).
PAPER_TRAIN = {"n_local_steps": 10, "batch_size": 50, "lr": 0.05}

#: default summary stats emitted per grid point by run_sweep_emit
EMIT_STATS = {"loss": "final_loss", "acc": "final_acc"}


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    ROWS.append((name, us_per_call, derived))
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)


def sync(device) -> None:
    """Wait for the work queued on ``device``, or on every card of a mesh
    (a no-op for the CPU): a CUDA call returns before the device has run it."""
    from repro_torch.launch.mesh import Mesh, sync_mesh

    if isinstance(device, Mesh):
        sync_mesh(device)
    elif device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, *args, repeats: int = 3, warmup: int = 1, device=None, **kw) -> tuple[float, object]:
    """(µs per call, last result) of ``fn(*args, **kw)`` by the host clock.

    With ``device`` a CUDA device (or a mesh, each of whose cards is
    waited for) the clock starts after the warm-up's work has run and every
    timed call ends in ``torch.cuda.synchronize``, so a call's time is its
    device work's and not only its launches'.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
        sync(device)
    dt = (time.perf_counter() - t0) / repeats
    return dt * 1e6, out


def summarize(hist, rounds: int) -> dict:
    """The figure-level summary statistics of one run's History."""
    from repro_torch.fl.sweep import summarize_history

    return summarize_history(hist, rounds)


def run_spec(spec, *, dataset=None, on_round=None, device="cuda") -> dict:
    """Run one declarative experiment on ``device``; return its summary statistics.

    ``spec`` is an ``ExperimentSpec`` or its dict form; ``dataset``
    short-circuits the data section so a scenario matrix sharing one
    partition builds it once. The context manager guarantees async planner
    workers are released, and ``on_round`` streams each ``RoundRecord`` as
    it lands (the server's telemetry hook) — no hand-rolled collection.
    """
    from repro_torch.fl.experiment import ExperimentSpec, build_experiment

    spec = ExperimentSpec.from_dict(spec) if isinstance(spec, dict) else spec
    with build_experiment(spec, dataset=dataset, device=device) as srv:
        hist = srv.run(on_round=on_round)
    return summarize(hist, spec.train.n_rounds)


def _add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="device the runs use (cuda, or cpu for the plain PyTorch versions)")


def device_from_argv(description: str, argv: "list[str] | None" = None) -> str:
    """Parse a runner's ``--device`` (default ``cuda``) and check it exists.

    Raises here, before any work, when CUDA is asked for and absent.
    """
    ap = argparse.ArgumentParser(description=description)
    _add_device(ap)
    device = ap.parse_args(argv).device
    resolve_device(device)
    return device


def parse_with_device(ap: argparse.ArgumentParser, argv: "list[str] | None") -> argparse.Namespace:
    """``ap``'s arguments plus ``--device`` (default ``cuda``), checked as
    :func:`device_from_argv` checks it. As the reference's ``bench_*``
    modules, ``argv=None`` (a programmatic caller) parses no arguments."""
    _add_device(ap)
    args = ap.parse_args([] if argv is None else argv)
    resolve_device(args.device)
    return args


def run_sweep_emit(
    sweep,
    label: str,
    *,
    stats: "dict[str, str] | None" = None,
    workers: int = 1,
    device="cuda",
) -> list[dict]:
    """Run a SweepSpec on ``device`` through the campaign runner; emit mean±std rows.

    One ``emit`` row per grid point (``label/axis=value/...``) carrying
    ``short=mean±std`` for each stat in ``stats`` (default loss/acc) and
    the mean per-round wall time of the grid point's cells. The RunStore
    is ephemeral unless ``$BENCH_SWEEP_STORE`` is set, in which case the
    campaign is resumable and leaves its figure-ready ``cells.csv`` /
    ``summary.csv`` behind under ``$BENCH_SWEEP_STORE/<label>``.
    Returns the aggregated rows for derived emits (e.g. fig2's gain).
    """
    from repro_torch.fl.sweep import SweepSpec, collate, run_sweep, write_collated

    sweep = SweepSpec.from_dict(sweep) if isinstance(sweep, dict) else sweep
    stats = EMIT_STATS if stats is None else stats
    durations: dict[str, float] = {}
    with contextlib.ExitStack() as stack:
        if os.environ.get("BENCH_SWEEP_STORE"):
            root = os.path.join(os.environ["BENCH_SWEEP_STORE"], label.replace("/", "_"))
        else:
            root = stack.enter_context(tempfile.TemporaryDirectory(prefix=f"sweep-{label.replace('/', '_')}-"))
        # only freshly-run cells carry a real wall time; resumed (skipped)
        # cells must not drag the emitted per-round timing toward zero
        store = run_sweep(
            sweep, root, workers=workers, device=device,
            on_cell=lambda cell, status, summary, dt: (
                durations.__setitem__(cell.cell_id, dt) if status == "ran" else None
            ),
        )
        cell_rows, agg_rows = collate(store)
        write_collated(store, rows=(cell_rows, agg_rows))
    axis_paths = list(sweep.axes)
    rounds = sweep.base.train.n_rounds
    for row in agg_rows:
        group = [r for r in cell_rows if r["grid"] == row["grid"]]
        dts = [durations[r["cell"]] for r in group if r["cell"] in durations]
        us = (sum(dts) / len(dts)) * 1e6 / max(rounds, 1) if dts else 0.0
        name = "/".join(
            [label] + [f"{p.split('.')[-1]}={row[p]}" for p in axis_paths]
        )
        derived = ";".join(
            f"{short}={row[f'{stat}_mean']:.4f}±{row[f'{stat}_std']:.4f}"
            for short, stat in stats.items()
        )
        emit(name, us, f"{derived};seeds={row['n_seeds']}")
    return agg_rows
