# Adapted from benchmarks/bench_kernels.py: the same three kernels at the same
# shapes, each timed as its plain version and through its wrapper.
"""Kernel microbenchmarks: the port's similarity, aggregate and flash
kernels at the reference's shapes, each beside its plain PyTorch version.

The reference times a jnp oracle (``*_ref_cpu``) and, for the similarity
kernel, the Pallas interpreter. The port keeps those rows one for one under
names that say what ran (:data:`ROW_MAP`): ``kernels/<kernel>_plain`` is the
plain version in the kernel's ``ref.py``; ``kernels/similarity_cuda`` is the
arccos distances through the CUDA similarity kernel's wrapper. Two rows have
no reference counterpart (:data:`EXTRA_ROWS`): ``kernels/aggregate_cuda`` and
``kernels/flash_attention_cuda``, the wrapper of the aggregate kernel and of
the f32 flash kernel (``flash_fwd_f32``). On the CPU a wrapper runs its
plain version: its rows then time that.

Times are µs per call by the host clock, each call ending in
``torch.cuda.synchronize`` on the card. The derived column keeps the
reference's shape and FLOP or byte count; a wrapper row adds the H100 bound
(``h100_bound_ms``: the larger of the bytes moved over 3.35 TB/s and the
operations over 67 TFLOP/s f32, the H100 SXM's data-sheet peaks; each input
read once, each output written once; the Gram over its i ≤ j triangle, the
causal attention over its lower triangle), the max abs error against the
plain version on the same inputs, and on the card ``event_ms``: the mean of
50 back-to-back calls by CUDA events, the device's time without the host's
wait, and ``library_event_ms``: the same for one PyTorch call that computes
the kernel's function on the same inputs (``G @ G.T``, ``torch.mv(U.T, w)``,
``scaled_dot_product_attention``), timed here and used nowhere in the port.

Run: ``python -m repro_torch.benchmarks.bench_kernels [--device cpu]``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, parse_with_device, timed
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.aggregate.ops import aggregate_flat
from repro_torch.kernels.aggregate.ref import aggregate_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention_padded
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.similarity import ops as sim_ops
from repro_torch.kernels.similarity.ops import pairwise_distances_device, pairwise_sums
from repro_torch.kernels.similarity.ref import distances_from_gram, gram_ref

#: the reference's row -> the port's
ROW_MAP = {
    "kernels/similarity_gram_ref_cpu": "kernels/similarity_gram_plain",
    "kernels/similarity_pallas_interpret": "kernels/similarity_cuda",
    "kernels/aggregate_ref_cpu": "kernels/aggregate_plain",
    "kernels/flash_attention_ref_cpu": "kernels/flash_attention_plain",
}
#: the port's rows with no reference counterpart
EXTRA_ROWS = ("kernels/aggregate_cuda", "kernels/flash_attention_cuda")

#: H100 SXM data-sheet peaks: HBM bytes/s and f32 FLOP/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
EVENT_REPS = 50


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(the H100's least time in ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def event_ms(fn, reps: int = EVENT_REPS) -> float:
    """Mean ms a call of ``fn`` over ``reps`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_fields(device, fn, nbytes: float, flops: float, err: float, library) -> str:
    ms, by = bound_ms(nbytes, flops)
    fields = f"h100_bound_ms={ms:.6f};bound_by={by};max_abs_err={err:.3e}"
    if torch.device(device).type == "cuda":
        fields += f";event_ms={event_ms(fn):.6f};library_event_ms={event_ms(library):.6f}"
    return fields


def main(argv: "list[str] | None" = None) -> None:
    args = parse_with_device(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    dev = args.device
    rng = np.random.default_rng(0)

    # similarity: n=100 clients (paper scale), d = MLP parameter count
    n, d = 100, 2060
    G = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=dev)
    us, want = timed(lambda: gram_ref(G), device=dev)
    emit("kernels/similarity_gram_plain", us, f"n={n};d={d};flops={2 * n * n * d:.2e}")
    dist = lambda: pairwise_distances_device(G, "arccos")  # noqa: E731
    us, got = timed(dist, device=dev)
    norms = G.double().norm(dim=1)
    gram_err = float(((pairwise_sums(G, "gram").double() - want.double()).abs()
                      / (norms[:, None] * norms[None, :])).max())
    err = float((got - distances_from_gram(want, "arccos")).abs().max())
    flops, nbytes = sim_ops.work(n, d, "gram")
    fields = _kernel_fields(dev, dist, nbytes, flops, err, library=lambda: G @ G.T)
    emit("kernels/similarity_cuda", us,
         f"mode=arccos;{fields};gram_err={gram_err:.3e} of |g_i||g_j|")

    # aggregation: m=10 clients × 1M-param model
    k, p = 10, 1_000_000
    U = torch.as_tensor(rng.normal(size=(k, p)), dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.normal(size=(k,)), dtype=torch.float32, device=dev)
    us, want = timed(lambda: aggregate_ref(U, w), device=dev)
    emit("kernels/aggregate_plain", us, f"k={k};p={p};bytes={4 * k * p:.2e}")
    agg = lambda: aggregate_flat(U, w)  # noqa: E731
    us, got = timed(agg, device=dev)
    err = float((got - want).abs().max())
    flops, nbytes = agg_ops.work(k, p)
    emit("kernels/aggregate_cuda", us,
         f"k={k};p={p};{_kernel_fields(dev, agg, nbytes, flops, err, lambda: torch.mv(U.T, w))}")

    # flash attention: causal GQA in f32 (the CUDA-core kernel)
    b, s, h, kv, hd = 1, 256, 8, 2, 64
    q = torch.as_tensor(rng.normal(size=(b, s, h, hd)), dtype=torch.float32, device=dev)
    kk = torch.as_tensor(rng.normal(size=(b, s, kv, hd)), dtype=torch.float32, device=dev)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)), dtype=torch.float32, device=dev)
    us, want = timed(lambda: flash_attention_plain(q, kk, v), device=dev)
    emit("kernels/flash_attention_plain", us, f"b={b};s={s};h={h};kv={kv};hd={hd}")
    fa = lambda: flash_attention_padded(q, kk, v)  # noqa: E731
    us, got = timed(fa, device=dev)
    err = float((got - want).abs().max())
    flops, nbytes = fa_ops.work(b, s, s, h, kv, hd)  # the causal half; q, out, k, v once each
    qt, kt, vt = (a.transpose(1, 2) for a in (q, kk, v))  # SDPA's (B, H, S, hd)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    emit("kernels/flash_attention_cuda", us,
         f"b={b};s={s};h={h};kv={kv};hd={hd};{_kernel_fields(dev, fa, nbytes, flops, err, sdpa)}")


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
