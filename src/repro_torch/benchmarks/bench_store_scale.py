# Adapted from benchmarks/bench_store_scale.py: the same cells, cap and rows,
# the store on a device, its update block a device tensor as the engine's.
"""Sketched GradientStore at scale: resident bytes, scatter, rebuild.

The claim under measurement: with ``sketch="srp"`` the store's resident
buffer — and the whole plan-rebuild pipeline behind it — scales in
``d_prime`` instead of the model dimension ``d``, taking Algorithm 2's plan
rebuilds from the paper's n=400 toward n=10⁶ clients.

Section 1 — store footprint + scatter: for each (n, d) cell, build the
store exact and sketched (srp, d'=``D_PRIME``), report resident bytes and
the warm per-round scatter time of a (c, d) update block (sketch + dedupe
+ ``index_copy_``), the block a device tensor as the engine's round output
is. A sketched scatter is one launch of the SRP sketch kernel; the srp
rows count them (``scatters=``, ``srp_launches=``: 0 on the CPU, where the
kernel's plain version runs). Exact cells whose (n, d) f32 buffer would
exceed ``EXACT_BYTE_CAP`` are reported as ``infeasible`` rather than
allocated: those are the cells only the sketched store can hold.

Section 2 — plan rebuild: one ``build_plan_algorithm2`` call (``kmeans``
clusterer, on the snapshot's device — no (n, n) matrix on this path) over
the store's snapshot, exact (n, d) vs sketched (n, d'). The acceptance cell
is n=10⁵, d=10⁴: exact is byte-capped while the sketched rebuild completes.

Run: ``python -m repro_torch.benchmarks.bench_store_scale [--smoke] [--device cpu]``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, parse_with_device, timed
from repro_torch.kernels.sketch import ops as sk_ops

#: sketch width of every sketched cell (the README scaling table's d')
D_PRIME = 64

#: largest exact (n, d) f32 buffer this benchmark will actually allocate;
#: cells past the cap are emitted as infeasible instead of attempted
EXACT_BYTE_CAP = 1 << 30


def _store(n: int, d: int, *, sketch=None, sketch_dim=None, device="cuda"):
    from repro_torch.fl.gradient_store import GradientStore

    return GradientStore(n, d, sketch=sketch, sketch_dim=sketch_dim, device=device)


def _scatter_us(store, ids: np.ndarray, updates, repeats: int) -> float:
    def step():
        store.update(ids, updates)
        return store.snapshot()

    us, _ = timed(step, repeats=repeats, warmup=1, device=store.device)
    return us


def _block(rng, n: int, d: int, c: int, device):
    ids = rng.choice(n, size=min(c, n), replace=False).astype(np.int32)
    updates = rng.normal(size=(ids.size, d)).astype(np.float32)
    return ids, torch.as_tensor(updates, device=device)


def _section_store(cells, *, c: int, repeats: int, device) -> None:
    rng = np.random.default_rng(0)
    for n, d in cells:
        ids, updates = _block(rng, n, d, c, device)
        exact_bytes = n * d * 4
        label = f"store/n={n}/d={d}"
        if exact_bytes > EXACT_BYTE_CAP:
            emit(
                f"{label}/exact", 0.0,
                f"infeasible: {exact_bytes / 2**30:.1f}GiB resident > "
                f"{EXACT_BYTE_CAP / 2**30:.0f}GiB cap",
            )
        else:
            st = _store(n, d, device=device)
            us = _scatter_us(st, ids, updates, repeats)
            emit(f"{label}/exact", us, f"bytes={st.nbytes};scatter of ({ids.size},{d})")
            del st
        dp = min(D_PRIME, d)
        st = _store(n, d, sketch="srp", sketch_dim=dp, device=device)
        before = sk_ops.launches["srp"]
        us = _scatter_us(st, ids, updates, repeats)
        emit(
            f"{label}/srp{dp}", us,
            f"bytes={st.nbytes};ratio={exact_bytes / st.nbytes:.0f}x smaller;"
            f"scatters={repeats + 1};srp_launches={sk_ops.launches['srp'] - before}",
        )
        del st


def _rebuild_us(G, n: int, m: int, repeats: int, *, warmup: int = 1) -> float:
    from repro_torch.core.samplers.algorithm2 import build_plan_algorithm2
    from repro_torch.core.types import ClientPopulation

    pop = ClientPopulation(np.full(n, 100))
    us, _ = timed(
        lambda: build_plan_algorithm2(pop, m, G, clusterer="kmeans"),
        repeats=repeats, warmup=warmup, device=G.device,
    )
    return us


def _section_rebuild(cells, *, c: int, m: int, repeats: int, device) -> None:
    rng = np.random.default_rng(1)
    for n, d in cells:
        ids, updates = _block(rng, n, d, c, device)
        label = f"rebuild/n={n}/d={d}"
        exact_bytes = n * d * 4
        if exact_bytes > EXACT_BYTE_CAP:
            emit(
                f"{label}/exact", 0.0,
                f"infeasible: (n,d) snapshot {exact_bytes / 2**30:.1f}GiB "
                "exceeds cap; sketched path below is the only one that runs",
            )
        else:
            st = _store(n, d, device=device)
            st.update(ids, updates)
            us = _rebuild_us(st.snapshot(), n, m, repeats)
            emit(f"{label}/exact", us, "kmeans plan build on (n,d) snapshot (warm)")
            del st
        dp = min(D_PRIME, d)
        st = _store(n, d, sketch="srp", sketch_dim=dp, device=device)
        st.update(ids, updates)
        us = _rebuild_us(st.snapshot(), n, m, repeats)
        emit(f"{label}/srp{dp}", us, f"kmeans plan build on (n,{dp}) snapshot (warm)")
        del st


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny sizes for CI")
    args = parse_with_device(ap, argv)

    if args.smoke:
        cells = [(200, 2048), (400, 2048)]
        c, m, repeats = 32, 5, 1
        rebuild_cells = cells
    else:
        cells = [(1_000, 10_000), (1_000, 100_000), (10_000, 10_000),
                 (10_000, 100_000), (100_000, 10_000)]
        c, m, repeats = 64, 20, 2
        # the acceptance cell (n=1e5, d=1e4) plus one mid-scale exact point
        rebuild_cells = [(10_000, 10_000), (100_000, 10_000)]
    _section_store(cells, c=c, repeats=repeats, device=args.device)
    _section_rebuild(rebuild_cells, c=c, m=m, repeats=repeats, device=args.device)


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
