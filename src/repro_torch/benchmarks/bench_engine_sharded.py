# Adapted from benchmarks/bench_engine_sharded.py: the same data, model,
# sizes and rows, over a mesh of cards (or CPU shards with --device cpu).
"""Sharded batched round engine: µs a round and per-device staged bytes vs
mesh size.

The engine's client axis is embarrassingly parallel: with a mesh, each data
group trains its block of the round's clients on its own card and the
staged dataset is split over its client axis, so per-device pinned bytes
shrink with the mesh, while one process drives every card and the weighted
aggregation is the one cross-group step. Mesh sizes 1, 2 and 4, up to the
visible cards (``--device cpu``: all three, as CPU shards, whose wall clock
measures the round's host work, not scaling). The per-device staged bytes
column is the hardware-independent signal; ``launches=`` counts the
aggregate kernel's launches of the timed rounds (one a data group a round;
0 on the CPU, where no kernel runs).

Run: ``python -m repro_torch.benchmarks.bench_engine_sharded [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.bench_round_engine import _dataset
from repro_torch.benchmarks.common import emit, parse_with_device, sync
from repro_torch.fl.engine import staged_bytes
from repro_torch.fl.experiment import build_sampler
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.simple import init_mlp
from repro_torch.optim import sgd


def _rounds_per_sec(dataset, m: int, mesh, *, rounds: int, dim: int, cfg_kw, device):
    """(rounds/s, per-device staged bytes, aggregate launches) of ``rounds``
    rounds after one warm-up round."""
    params = init_mlp((dim, 32, 10), seed=1, device=device)
    cfg = FLConfig(
        n_rounds=rounds, seed=0, eval_every=10**9, engine="batched",
        mesh_spec=mesh, **cfg_kw,
    )
    sampler = build_sampler({"name": "md", "m": m, "seed": 0}, dataset.population, device=device)
    with FederatedServer(dataset, sampler, params, sgd(0.05), cfg, device=device) as srv:
        srv.run_round(0)  # warm-up: staging and first calls
        sync(mesh)
        before = agg_ops.launches["aggregate"]
        t0 = time.perf_counter()
        for t in range(1, rounds + 1):
            srv.run_round(t)
        sync(mesh)
        dt = time.perf_counter() - t0
        return (rounds / dt, srv._engine.per_device_staged_bytes(),
                agg_ops.launches["aggregate"] - before)


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    args = parse_with_device(ap, argv)

    dim, m = 16, 8
    rounds = 3 if args.smoke else 10
    cfg_kw = dict(
        n_local_steps=4 if args.smoke else 10, batch_size=16 if args.smoke else 32
    )
    dataset = _dataset(n_clients=80, dim=dim, per_client=50 if args.smoke else 200)
    avail = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 4
    sizes = [d for d in (1, 2, 4) if d <= avail]
    total = staged_bytes(dataset, m, cfg_kw["n_local_steps"], cfg_kw["batch_size"])

    base_rps = None
    for d in sizes:
        mesh = None if d == 1 else make_host_mesh(d, 1, device=args.device)
        rps, per_dev, launches = _rounds_per_sec(
            dataset, m, mesh, rounds=rounds, dim=dim, cfg_kw=cfg_kw, device=args.device
        )
        base_rps = base_rps or rps
        emit(
            f"engine_sharded/mesh={d}x1",
            1e6 / rps,
            f"us per round; per_device_staged={per_dev / 2**20:.2f}MiB "
            f"(total_estimate={total / 2**20:.2f}MiB); speedup={rps / base_rps:.2f}x;"
            f"launches={launches}",
        )
    if len(sizes) == 1:
        emit(
            "engine_sharded/single_device_only",
            0.0,
            "one card visible: the 2- and 4-card meshes need more cards "
            "(--device cpu runs them as CPU shards)",
        )


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
