# Adapted from src/repro/launch/fl_service.py: the port's spec layer, with
# a --device argument.
"""Continuous FL service: churn-tolerant, SIGTERM-safe, resumable.

Runs an :class:`~repro_torch.fl.experiment.ExperimentSpec` as a *service*
instead of a batch job: the population process decides who is reachable
each round, the server checkpoints its full state on the configured
cadence, and SIGTERM/SIGINT request a clean stop — the current round
finishes, a final checkpoint is written, and the process exits 0. A later
invocation with ``--resume`` reconstructs mid-campaign and continues
bit-identically to the run that was never killed.

Usage::

    python -m repro_torch.launch.fl_service --spec spec.json \\
        --checkpoint runs/svc.npz --history runs/history.json
    # ... SIGTERM lands, process exits cleanly ...
    python -m repro_torch.launch.fl_service --spec spec.json \\
        --checkpoint runs/svc.npz --history runs/history.json --resume

The spec's ``train.checkpoint_every`` sets the cadence (10 if the spec
leaves it at 0). ``--throttle`` sleeps between rounds, making small runs
long enough for a signal to land mid-campaign. ``--device`` defaults to
``cuda`` and raises without a GPU; ``--device cpu`` runs the plain
versions of the kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run an ExperimentSpec as a crash-safe continuous FL service"
    )
    ap.add_argument("--spec", required=True, help="ExperimentSpec JSON (inline or file path)")
    ap.add_argument("--checkpoint", required=True, help="server state bundle path (.npz)")
    ap.add_argument("--history", default=None, help="write the run History JSON here on exit")
    ap.add_argument("--resume", action="store_true", help="restore from --checkpoint and continue")
    ap.add_argument(
        "--skip-empty", action="store_true",
        help="ride out all-offline / all-dropped rounds as round_status='empty' "
        "records instead of failing the service",
    )
    ap.add_argument(
        "--throttle", type=float, default=0.0,
        help="seconds to sleep after each round (keeps short campaigns alive "
        "long enough for a SIGTERM to land mid-run)",
    )
    ap.add_argument(
        "--status-every", type=int, default=1, metavar="N",
        help="print the per-round status line only every N rounds (default 1: "
        "every round); the service summary always prints",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of the model, client data and gradient store (default "
        "cuda, which raises without a GPU; 'cpu' runs the plain versions)",
    )
    args = ap.parse_args(argv)
    if args.status_every < 1:
        ap.error(f"--status-every must be >= 1, got {args.status_every}")

    from repro_torch.device import resolve_device
    from repro_torch.fl.experiment import ExperimentSpec, load_spec_dict

    device = resolve_device(args.device)
    spec = ExperimentSpec.from_dict(load_spec_dict(args.spec))
    if spec.train.checkpoint_every <= 0:
        spec = dataclasses.replace(
            spec, train=dataclasses.replace(spec.train, checkpoint_every=10)
        )

    # SIGTERM/SIGINT → finish the in-flight round, checkpoint, exit cleanly.
    # A plain flag (not an exception) so the signal can land anywhere —
    # including inside a kernel launch — without corrupting state.
    stop = {"flag": False, "signal": None}

    def _request_stop(signum, frame):
        del frame
        stop["flag"] = True
        stop["signal"] = signum

    old = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}

    done_this_run = {"n": 0}

    def on_round(rec):
        done_this_run["n"] += 1
        if rec.round % args.status_every == 0:
            late = f" late={rec.n_late} harvested={rec.n_harvested}" if (
                rec.n_late or rec.n_harvested
            ) else ""
            print(
                f"[round {rec.round}] status={rec.round_status} "
                f"loss={rec.train_loss:.4f} acc={rec.test_acc:.4f} "
                f"avail={rec.n_available} dropped={rec.n_dropped}{late} "
                f"drift={rec.plan_drift:.3f} build_ms={rec.plan_build_ms:.1f}",
                flush=True,
            )
        if args.throttle > 0:
            time.sleep(args.throttle)

    try:
        with spec.build(checkpoint_path=args.checkpoint, device=device) as srv:
            if args.resume:
                if not os.path.exists(args.checkpoint):
                    print(f"error: --resume but no checkpoint at {args.checkpoint}", file=sys.stderr)
                    return 2
                start = srv.resume()
                print(f"resuming at round {start} from {args.checkpoint}", flush=True)
            t0 = time.time()
            history = srv.run(
                on_round, should_stop=lambda: stop["flag"], skip_empty=args.skip_empty
            )
            wall = time.time() - t0
            if stop["flag"]:
                # run() already wrote the stop checkpoint; make the cut
                # explicit in the log for operators
                print(
                    f"stop requested (signal {stop['signal']}); "
                    f"checkpointed at round cursor {srv._round_cursor} "
                    f"to {args.checkpoint}",
                    flush=True,
                )
            elif spec.train.checkpoint_every:
                srv.checkpoint()  # final state, even off-cadence
            if args.history:
                os.makedirs(os.path.dirname(os.path.abspath(args.history)), exist_ok=True)
                with open(args.history, "w") as f:
                    f.write(history.to_json())
            n = done_this_run["n"]
            rps = n / wall if wall > 0 else float("inf")
            ok = sum(r.round_status == "ok" for r in history.records)
            deg = sum(r.round_status == "degraded" for r in history.records)
            emp = sum(r.round_status == "empty" for r in history.records)
            print(
                f"service summary: {n} rounds this invocation "
                f"({len(history.records)} total: {ok} ok / {deg} degraded / {emp} empty), "
                f"sustained {rps:.2f} rounds/s",
                flush=True,
            )
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # a downstream reader closed stdout; the durable state is the
        # checkpoint, not the log stream — point stdout at devnull so the
        # interpreter's shutdown flush does not raise again
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        sys.exit(0)
