# Adapted from benchmarks/bench_round_engine.py: the same data, model, sizes
# and rows, on a device, with the aggregate kernel's launches counted.
"""Round-throughput: batched on-device engine vs the compat per-client loop.

The looped path pays m local-training loops + m host-side parameter
flattens per round; the batched engine runs the whole round (local
training, aggregation, representative gradients) over a padded client
axis, with the dataset resident on the device. Both close the round with
one launch of the aggregate kernel (its plain version on the CPU); the
derived column counts the launches of the timed rounds (``launches=``,
0 on the CPU, where no kernel runs). The reference's acceptance target
(>= 3x at m = 40) was set on the CPU.

Run: ``python -m repro_torch.benchmarks.bench_round_engine [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import emit, parse_with_device, sync
from repro_torch.fl.experiment import build_sampler
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.models.simple import init_mlp
from repro_torch.optim import sgd


def _dataset(n_clients: int, dim: int, per_client: int):
    from repro_torch.data.federated import ClientData, FederatedDataset

    rng = np.random.default_rng(0)
    clients = []
    for c in range(n_clients):
        x = rng.normal(size=(per_client, dim)).astype(np.float32)
        y = rng.integers(0, 10, size=per_client)
        clients.append(
            ClientData(x_train=x, y_train=y, x_test=x[:8], y_test=y[:8])
        )
    return FederatedDataset(clients)


def _rounds_per_sec(dataset, m: int, engine: str, *, rounds: int, dim: int,
                    device="cuda") -> tuple[float, int]:
    """(rounds/s, aggregate-kernel launches) of ``rounds`` rounds after one
    warm-up round."""
    params = init_mlp((dim, 32, 10), seed=1, device=device)
    cfg = FLConfig(
        n_rounds=rounds, n_local_steps=10, batch_size=32,
        seed=0, eval_every=10**9, engine=engine,
    )
    sampler = build_sampler({"name": "md", "m": m, "seed": 0}, dataset.population, device=device)
    with FederatedServer(dataset, sampler, params, sgd(0.05), cfg, device=device) as srv:
        srv.run_round(0)  # warm-up: staging and first calls
        sync(device)
        before = agg_ops.launches["aggregate"]
        t0 = time.perf_counter()
        for t in range(1, rounds + 1):
            srv.run_round(t)
        sync(device)
        dt = time.perf_counter() - t0
        return rounds / dt, agg_ops.launches["aggregate"] - before


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    args = parse_with_device(ap, argv)

    dim = 16
    ms = (5,) if args.smoke else (5, 10, 40)
    rounds = 3 if args.smoke else 12
    dataset = _dataset(n_clients=80, dim=dim, per_client=100)

    for m in ms:
        rps, launches = {}, {}
        for engine in ("compat", "batched"):
            rps[engine], launches[engine] = _rounds_per_sec(
                dataset, m, engine, rounds=rounds, dim=dim, device=args.device)
        speedup = rps["batched"] / rps["compat"]
        emit(
            f"round_engine/m={m}/compat", 1e6 / rps["compat"],
            f"us per round;launches={launches['compat']}",
        )
        emit(
            f"round_engine/m={m}/batched",
            1e6 / rps["batched"],
            f"us per round; speedup={speedup:.2f}x;launches={launches['batched']}",
        )


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
