"""Frozen work arithmetic and the card's peaks: the yardstick of every
roofline and utilisation metric, computed from a call's shapes alone.

Frozen copies, so that a later change to the port's own counters cannot
move the benchmark's bounds:
  * :func:`model_flops`, :func:`active_params` — from
    ``src/repro_torch/launch/roofline.py`` (``model_flops``,
    ``active_params``), over the benchmark's own leaf list;
  * :func:`aggregate_work` — ``src/repro_torch/kernels/aggregate/ops.py`` ``work``;
  * :func:`sketch_work` — ``src/repro_torch/kernels/sketch/ops.py`` ``work``;
  * :func:`flash_work` — ``src/repro_torch/kernels/flash_attention/ops.py`` ``work``;
  * :func:`gram_work` — ``src/repro_torch/kernels/similarity/ops.py`` ``work``.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, and HBM3.
#: The highest dense rate bounds every least time, so no implementation
#: (f32, TF32 or bf16) can read above 100 %.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the card needs at the least: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for forward-only (prefill / decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def active_params(leaves, moe_top_k: int = 0, moe_n_routed: int = 0) -> tuple[int, int]:
    """(total, active) parameter counts of ``leaves`` — (name, shape)
    pairs; a routed expert's leaf (``e_gate``, ``e_up``, ``e_down``)
    counts at top_k / n_routed."""
    total, active = 0, 0.0
    for name, shape in leaves:
        size = 1
        for n in shape:
            size *= int(n)
        total += size
        if moe_n_routed and name.rsplit(".", 1)[-1] in ("e_gate", "e_up", "e_down"):
            active += size * (moe_top_k / moe_n_routed)
        else:
            active += size
    return total, int(active)


def aggregate_work(k: int, p: int) -> tuple[int, int]:
    """(operations, bytes) of B2 on (k, p): a multiply-add an element; the
    rows and weights read once, the (p,) sum written once (f32)."""
    return 2 * k * p, 4 * (k * p + k + p)


def sketch_work(c: int, d: int, d_prime: int) -> tuple[int, int]:
    """(operations, bytes) of B3 on (c, d) -> (c, d'): X · S at 2 FLOP a
    multiply-add; X read once, Y written once (S is regenerated from the
    hash, never read)."""
    return 2 * c * d * d_prime, 4 * (c * d + c * d_prime)


def flash_work(b: int, s: int, t: int, h: int, kv: int, hd: int, *, causal: bool = True,
               itemsizes: tuple[int, int, int] = (2, 2, 2)) -> tuple[int, int]:
    """(operations, bytes) of one B4 forward: QKᵀ and PV at 2 FLOP a
    multiply-add over the S × T scores, half of them when causal; q and
    the output, k and v each read or written once."""
    flops = 4 * b * h * hd * s * t
    iq, ik, iv = itemsizes
    return flops // 2 if causal else flops, 2 * iq * b * s * h * hd + (ik + iv) * b * t * kv * hd


def gram_work(n: int, d: int) -> tuple[int, int]:
    """(operations, bytes) of B1's Gram on (n, d) over the i <= j half; G
    read once, the (n, n) output written once."""
    return n * (n + 1) * d, 4 * (n * d + n * n)
