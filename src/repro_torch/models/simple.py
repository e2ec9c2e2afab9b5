"""The paper's MLP classifier, as plain functions over a dict of tensors.

Port of ``src/repro/models/simple.py``. Parameters keep the reference's
layout — ``w{i}`` of shape (in, out), ``b{i}`` of shape (out,) — so a
reference ``init_mlp`` dict carries across with :func:`params_from_numpy`.
Every function also takes parameters stacked over a leading client axis
(``w{i}`` of shape (m, in, out)) with inputs (m, B, in): the batched round
engine trains all sampled clients at once that way, and the per-client
losses come back as an (m,) tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device


class MLP(nn.Module):
    """(in, hidden..., out) dense ReLU stack, He-initialized."""

    def __init__(
        self,
        dims: tuple[int, ...],
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.n_layers = len(dims) - 1
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((d_in, d_out), generator=generator) * math.sqrt(2.0 / d_in)
            setattr(self, f"w{i}", nn.Parameter(w.to(dev)))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(d_out, device=dev)))

    def params(self) -> dict:
        return {k: v for k, v in self.named_parameters()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self.params(), x)


def init_mlp(dims: tuple[int, ...], seed: int = 0, device="cuda") -> dict:
    """He-initialized parameters drawn from a ``torch.Generator`` seeded with
    ``seed``. Not bit-equal to the reference's ``init_mlp`` (jax threefry);
    parity tests carry the reference's parameters across instead."""
    gen = torch.Generator().manual_seed(seed)
    model = MLP(dims, generator=gen, device=device)
    return {k: v.detach() for k, v in model.params().items()}


def params_from_numpy(params: dict, device="cuda") -> dict:
    """A reference parameter dict (numpy or jax arrays) -> f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
        for k, v in params.items()
    }


def params_to_numpy(params: dict) -> dict:
    """Port parameters -> a dict of host numpy arrays (the reference's layout)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits for (B, in) inputs, or (m, B, in) with client-stacked params."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if w.dim() == 3:
            h = torch.baddbmm(b.unsqueeze(1), h, w)
        else:
            h = h @ w + b
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis; (m,) for client-stacked input."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return -picked.mean(dim=-1)


def classification_loss(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return softmax_xent(apply_mlp(params, x), y)


def accuracy(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (apply_mlp(params, x).argmax(-1) == y).to(torch.float32).mean(dim=-1)


def fedprox_loss(
    params: dict, x: torch.Tensor, y: torch.Tensor, global_params: dict, mu: float
) -> torch.Tensor:
    """Local loss + (mu/2)||θ - θ_global||² (Appendix D.5, Li et al. 2018).

    With client-stacked params the proximal term is taken per client."""
    base = classification_loss(params, x, y)
    lead = y.dim() - 1  # 1 for client-stacked input, else 0
    prox = sum(
        torch.square(params[k] - global_params[k]).flatten(start_dim=lead).sum(dim=-1)
        for k in sorted(params)
    )
    return base + 0.5 * mu * prox
