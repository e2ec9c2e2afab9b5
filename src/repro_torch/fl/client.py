"""Client-side local work: N SGD steps from the received global model.

Port of ``src/repro/fl/client.py``. ``jax.lax.scan`` over the (N, B) index
rows becomes a Python loop. :func:`local_steps` takes one client's
parameters and data, or every client's at once with a leading client axis
(parameters (m, ...), x (m, n_pad, ...), y (m, n_pad), indices (m, N, B)):
the loss it differentiates is then the sum over clients of each client's
mean loss, so one ``autograd`` call gives every client exactly its own
gradient.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.optim.base import Optimizer, apply_updates

LossFn = Callable[..., torch.Tensor]  # (params, x, y, [global_params, mu]) -> loss


def local_steps(
    params: dict,
    x: torch.Tensor,
    y: torch.Tensor,
    batch_idx: torch.Tensor,  # (N, B) or (m, N, B) int64 rows into x/y
    loss_fn: LossFn,
    opt: Optimizer,
    fedprox_mu: float = 0.0,
):
    """Run N local steps; returns (updated params, mean local loss).

    The loss is a scalar for one client and an (m,) tensor for stacked
    clients.
    """
    global_params = {k: v.detach() for k, v in params.items()}
    keys = sorted(global_params)
    p = global_params
    opt_state = opt.init(p)
    stacked = batch_idx.dim() == 3
    rows = torch.arange(x.shape[0], device=x.device)[:, None] if stacked else None
    losses = []
    for t in range(batch_idx.shape[-2]):
        idx = batch_idx[..., t, :]
        xb, yb = (x[rows, idx], y[rows, idx]) if stacked else (x[idx], y[idx])
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        if fedprox_mu:
            loss = loss_fn(p, xb, yb, global_params, fedprox_mu)
        else:
            loss = loss_fn(p, xb, yb)
        grads = dict(zip(keys, torch.autograd.grad(loss.sum(), [p[k] for k in keys])))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, p, t)
            p = apply_updates(p, updates)
        losses.append(loss.detach())
    return p, torch.stack(losses).mean(dim=0)


#: The compat path's single-client round. PyTorch runs eagerly, so it is the
#: loop itself (the reference wraps it in ``jax.jit``).
local_update = local_steps


def draw_batch_indices(
    rng: np.random.Generator, n_data: int, n_steps: int, batch_size: int, device
) -> torch.Tensor:
    """Pre-draw the (N, B) batch index matrix for one client round, on
    ``device`` (the caller's; there is no default device)."""
    idx = rng.integers(0, n_data, size=(n_steps, batch_size))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)
