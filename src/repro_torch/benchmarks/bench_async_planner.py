# Adapted from benchmarks/bench_async_planner.py: the same sections, sizes
# and rows on a device; section 2's two rows time the one similarity kernel.
"""Async re-clustering planner: round wall-time with Algorithm 2's rebuild
on vs off the critical path, and the similarity stage's memory vs ``d``.

Section 1 — planner overlap: the same FL run (batched engine, Algorithm 2
sampler) with ``planner="sync"`` pays the O(n²d) distances + O(n³) Ward +
urn filling *inside* every round; ``planner="async"`` hands the rebuild to
a background worker and the round only pays a device scatter + snapshot.
Per-round plan staleness is reported as the mean ``plan_lag_rounds`` (0 for
sync by construction).

Section 2 — similarity over growing ``d``: the reference's two entry points
differ (a one-shot Pallas kernel that pads the whole (n, d) block to tiles,
and a streamed one that never pads it), and its rows report the padded
slab from the Pallas block arithmetic. In the port both entry points,
``pairwise_distances_device`` and ``pairwise_distances_streamed``, are one
launch of the same CUDA kernel, which streams d in 32-column chunks and
pads nothing; so the ``one_shot`` and ``streamed`` rows keep their names
and time that one kernel. Their derived column gives what the port
allocates instead: the d-split scratch's bound, splits × n × n × 4 bytes
where ``ops.split_plan`` splits d (none in one split; the kernel's scratch
holds only the i ≤ j lane blocks, about half of it), and on the card the
rise of ``torch.cuda.max_memory_allocated`` over the call, the scratch and
the (n, n) output (``not measured`` on the CPU).

Section 3 — rebuild at scale: one ``build_plan_algorithm2`` call per
(clusterer, n) cell. At moderate n the three registered clusterers are
compared end-to-end (host ward on the f64 host distances; ``ward_jit``
on the similarity kernel's device distances; ``kmeans`` on the device).
At n=10k clients (full mode) the host O(n³) Ward is infeasible, so the
section reports the device paths that remain: the k-means rebuild (cold +
warm — no (n, n) matrix at all on this path) and the distance stage alone
(host numpy f64 vs one launch of the similarity kernel).

``--drift`` adds Section 4 — the measured rebuild trigger: the same run
with a fixed ``rebuild_every=1`` cadence vs ``drift_threshold``, reporting
round wall-time, rebuilds actually executed, and the mean assignment-churn
statistic (``RoundRecord.plan_drift``).

Run: ``python -m repro_torch.benchmarks.bench_async_planner [--smoke] [--drift] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, parse_with_device, sync, timed


def _random_clients(n_clients: int, dim: int, per_client: int):
    from repro_torch.data.federated import ClientData, FederatedDataset

    rng = np.random.default_rng(0)
    clients = []
    for _ in range(n_clients):
        x = rng.normal(size=(per_client, dim)).astype(np.float32)
        y = rng.integers(0, 10, size=per_client)
        clients.append(ClientData(x_train=x, y_train=y, x_test=x[:8], y_test=y[:8]))
    return FederatedDataset(clients)


def _register_dataset():
    from repro_torch.fl.experiment import DATASETS

    if "random_clients" not in DATASETS:
        DATASETS.register("random_clients", _random_clients)


def _mean_round_time(dataset, planner: dict, *, m: int, rounds: int, dim: int, device="cuda"):
    """(mean s/round after a warm-up round, mean lag, rebuilds, mean drift).

    ``planner`` is the spec's planner section verbatim (mode, cadence or
    drift threshold). Rebuilds counts only post-initial plan builds; drift
    averages the measured ``plan_drift`` telemetry (-1.0 when the run never
    measured drift, i.e. fixed-cadence mode).
    """
    from repro_torch.fl.experiment import build_experiment

    spec = {
        "data": {
            "name": "random_clients",
            "options": {"n_clients": dataset.n_clients, "dim": dim, "per_client": 60},
        },
        "sampler": {"name": "algorithm2", "m": m},
        "planner": dict(planner),
        "train": {
            "n_rounds": rounds, "n_local_steps": 10, "batch_size": 32,
            "lr": 0.05, "seed": 0, "eval_every": 10**9, "hidden": [32],
        },
    }
    with build_experiment(spec, dataset=dataset, device=device) as srv:
        srv.run_round(0)  # warm-up: staging + first rebuild
        sync(device)
        t0 = time.perf_counter()
        for t in range(1, rounds + 1):
            srv.run_round(t)
        sync(device)
        dt = (time.perf_counter() - t0) / rounds
        lag = float(np.mean(srv.history.series("plan_lag_rounds")[1:]))
        rebuilds = srv.sampler.plan_service.rebuilds_done()
        drifts = [v for v in srv.history.series("plan_drift") if v >= 0]
        drift = float(np.mean(drifts)) if drifts else -1.0
    return dt, lag, rebuilds, drift


def split_scratch_bytes(n: int, d: int) -> tuple[int, int]:
    """(splits, bound of the scratch bytes) of one similarity launch over
    (n, d): an (n, n) f32 block a split where d is split, none in one split."""
    from repro_torch.kernels.similarity.ops import split_plan

    splits, _ = split_plan(n, d)
    return splits, (splits * n * n * 4 if splits > 1 else 0)


def _peak_rise(fn, device) -> str:
    """``fn``'s rise of the device's peak allocated bytes, in MiB."""
    if torch.device(device).type != "cuda":
        return "not measured"
    sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    sync(device)
    return f"{(torch.cuda.max_memory_allocated(device) - base) / 2**20:.2f}MiB"


def _streamed_sweep(d_values, *, n: int, device="cuda"):
    from repro_torch.kernels.similarity.ops import (
        pairwise_distances_device,
        pairwise_distances_streamed,
    )

    rng = np.random.default_rng(1)
    for d in d_values:
        G = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=device)
        fns = {"one_shot": lambda: pairwise_distances_device(G, "arccos"),
               "streamed": lambda: pairwise_distances_streamed(G, "arccos")}
        us, out = {}, {}
        for name, fn in fns.items():
            us[name], out[name] = timed(fn, repeats=2, device=device)
        np.testing.assert_allclose(out["one_shot"].cpu().numpy(), out["streamed"].cpu().numpy(),
                                   atol=1e-4)
        splits, scratch = split_scratch_bytes(n, d)
        for name, fn in fns.items():
            emit(
                f"similarity_streamed/n={n}/d={d}/{name}", us[name],
                f"one kernel launch;split_scratch={scratch / 2**20:.2f}MiB;splits={splits};"
                f"peak_rise={_peak_rise(fn, device)}",
            )


def _rebuild_scale(*, smoke: bool, device="cuda") -> None:
    """Section 3: plan-rebuild cost off the training profile.

    Every cell is one :func:`build_plan_algorithm2` call over a synthetic
    gradient block — exactly what the planner's worker executes. At n_big
    the host Ward is O(n³) ≈ 10¹² ops and is omitted as infeasible; the
    cells that remain are the device rebuild paths.
    """
    from repro_torch.core.clustering.similarity import pairwise_distances
    from repro_torch.core.samplers.algorithm2 import build_plan_algorithm2
    from repro_torch.core.types import ClientPopulation
    from repro_torch.kernels.similarity.ops import make_distance_fn, pairwise_distances_streamed

    n_small, n_big, d = (48, 200, 16) if smoke else (512, 10_000, 64)
    m_small, m_big = (5, 5) if smoke else (24, 50)
    rng = np.random.default_rng(0)

    # moderate n: the three registered clusterers end-to-end. ward_jit gets
    # the similarity kernel's device distances — the (n, n) matrix and the
    # Lance–Williams loop both stay on the device.
    G_small = rng.normal(size=(n_small, d)).astype(np.float32)
    G_small_dev = torch.as_tensor(G_small, device=device)
    pop_small = ClientPopulation(np.full(n_small, 100))
    cells = [
        ("ward_host", G_small, dict(distance_fn=None, clusterer="ward")),
        ("ward_jit", G_small_dev, dict(distance_fn=make_distance_fn(), clusterer="ward_jit")),
        ("kmeans", G_small_dev, dict(distance_fn=None, clusterer="kmeans")),
    ]
    repeats = 1 if smoke else 2
    for name, G, kw in cells:
        us, _ = timed(
            lambda G=G, kw=kw: build_plan_algorithm2(pop_small, m_small, G, **kw),
            repeats=repeats, device=device,
        )
        emit(f"plan_rebuild/n={n_small}/{name}", us, "full plan build (warm)")

    # n_big: the off-profile rebuild. kmeans clusters G directly — no (n, n)
    # matrix exists anywhere on this path, so it is the one that scales.
    G_big = rng.normal(size=(n_big, d)).astype(np.float32)
    G_big_dev = torch.as_tensor(G_big, device=device)
    pop_big = ClientPopulation(np.full(n_big, 100))
    big_build = lambda: build_plan_algorithm2(pop_big, m_big, G_big_dev, clusterer="kmeans")  # noqa: E731
    us_cold, _ = timed(big_build, repeats=1, warmup=0, device=device)
    us_warm, _ = timed(big_build, repeats=repeats, device=device)
    emit(f"plan_rebuild/n={n_big}/kmeans_cold", us_cold, "first build")
    emit(f"plan_rebuild/n={n_big}/kmeans_warm", us_warm, "no (n,n) matrix on this path")

    if not smoke:
        # distance stage alone at n_big: f64 host reference vs one launch of
        # the similarity kernel. host ward on top of it would be O(n^3).
        us_host, _ = timed(
            lambda: pairwise_distances(G_big, "arccos"), repeats=1, warmup=0
        )
        emit(
            f"plan_rebuild/n={n_big}/host_distances_only", us_host,
            "f64 numpy O(n^2 d) stage alone; host ward O(n^3) omitted (infeasible)",
        )
        us_fused, _ = timed(
            lambda: pairwise_distances_streamed(G_big_dev, "arccos"),
            repeats=1, warmup=0, device=device,
        )
        emit(
            f"plan_rebuild/n={n_big}/fused_distances", us_fused,
            "one launch of the similarity kernel (cold), no padded (n,d) block",
        )


def _drift_section(*, smoke: bool, device="cuda") -> None:
    """Section 4: measured drift trigger vs the fixed rebuild cadence."""
    dim = 16
    n = 40 if smoke else 200
    rounds = 2 if smoke else 6
    dataset = _random_clients(n_clients=n, dim=dim, per_client=60)
    fx_dt, _, fx_rb, _ = _mean_round_time(
        dataset, {"mode": "sync", "rebuild_every": 1}, m=10, rounds=rounds, dim=dim,
        device=device,
    )
    threshold = 0.2
    dr_dt, _, dr_rb, drift = _mean_round_time(
        dataset, {"mode": "sync", "drift_threshold": threshold},
        m=10, rounds=rounds, dim=dim, device=device,
    )
    emit(
        f"drift_planner/n={n}/fixed", fx_dt * 1e6,
        f"us per round; rebuilds={fx_rb}",
    )
    emit(
        f"drift_planner/n={n}/threshold={threshold}", dr_dt * 1e6,
        f"us per round; rebuilds={dr_rb} mean_drift={drift:.3f}",
    )


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    ap.add_argument(
        "--drift", action="store_true",
        help="also run the drift-triggered planner section",
    )
    args = parse_with_device(ap, argv)
    device = args.device

    _register_dataset()
    dim = 16
    ns = (40,) if args.smoke else (200, 400)
    rounds = 2 if args.smoke else 6
    for n in ns:
        dataset = _random_clients(n_clients=n, dim=dim, per_client=60)
        secs, lags = {}, {}
        for planner in ("sync", "async"):
            secs[planner], lags[planner], _, _ = _mean_round_time(
                dataset, {"mode": planner}, m=10, rounds=rounds, dim=dim, device=device
            )
        speedup = secs["sync"] / secs["async"]
        emit(f"async_planner/n={n}/sync", secs["sync"] * 1e6, "us per round; lag=0")
        emit(
            f"async_planner/n={n}/async", secs["async"] * 1e6,
            f"us per round; speedup={speedup:.2f}x "
            f"mean_lag={lags['async']:.2f} rounds",
        )

    if args.smoke:
        _streamed_sweep((96,), n=24, device=device)
    else:
        _streamed_sweep((512, 2048, 8192), n=128, device=device)

    _rebuild_scale(smoke=args.smoke, device=device)
    if args.drift:
        _drift_section(smoke=args.smoke, device=device)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
