"""Global-norm gradient clipping.

Port of ``src/repro/optim/clip.py`` over a dict of tensors: the squared
sums are taken in f32 leaf by leaf, in sorted-key order (jax's order for a
dict), and added in that order.
"""
from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    total = None
    for k in sorted(tree):
        s = tree[k].to(torch.float32).square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, norm
