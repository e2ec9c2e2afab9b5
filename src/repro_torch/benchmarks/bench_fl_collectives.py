# Adapted from benchmarks/bench_fl_collectives.py: the same byte accounting
# over the port's flat parameter vector.
"""Communication accounting: the paper's motivation is minimizing
server-client communication. This benchmark quantifies, per FL round and
per synchronous-DP step, the bytes a client/worker exchanges — showing the
N× collective reduction of FL local work vs synchronous data-parallelism,
and that clustered sampling costs ZERO extra bytes over MD sampling
(Section 5: only θ_i - θ differences the server already receives).

Byte counts only: nothing is timed (every row's time is 0).

Run: ``python -m repro_torch.benchmarks.bench_fl_collectives [--device cpu]``.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import emit, parse_with_device
from repro_torch.fl.aggregation import flatten_params
from repro_torch.models.simple import init_mlp


def main(argv: "list[str] | None" = None) -> None:
    args = parse_with_device(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    params = init_mlp((32, 50, 10), device=args.device)
    p_bytes = int(flatten_params(params).numel()) * 4
    n_local = 100  # N in the paper
    m = 10

    # per-round bytes per sampled client: download θ + upload θ_i
    fl_round = 2 * p_bytes
    # synchronous DP equivalent: N steps × grad exchange each
    sync = n_local * 2 * p_bytes
    emit("fl_comm/per_client_round_bytes", 0.0, f"bytes={fl_round}")
    emit("fl_comm/sync_dp_equivalent_bytes", 0.0, f"bytes={sync};ratio={sync / fl_round:.0f}x")
    # clustered sampling server-side extra: similarity matrix only (no wire bytes)
    emit("fl_comm/clustered_extra_wire_bytes", 0.0, "bytes=0;server_flops=n^2*d")
    # aggregation traffic at the server: m models in, 1 out
    emit("fl_comm/server_round_bytes", 0.0, f"bytes={(m + m) * p_bytes}")


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
