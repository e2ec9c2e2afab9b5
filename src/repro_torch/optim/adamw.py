"""AdamW for the LM trainer.

Port of ``src/repro/optim/adamw.py``, with the reference's order of
operations (not ``torch.optim.AdamW``'s): moments ``mu`` and ``nu`` in f32
whatever the parameters' dtype, an int32 ``count``, bias corrections
``1 / (1 - b**count)``, ``eps`` added outside the square root, and the
weight decay added to the step before it is scaled by ``-eta``.
``update`` writes the new moments into the state's own tensors (the
reference returns new arrays): at qwen3-0.6b that saves two 2.38 GB
copies a step. The operations are the reference's, rounded in its order.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, as_schedule


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = as_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = next(iter(params.values())).device
        return {
            "mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update(grads, state, params, step):
        del step
        count = state["count"] + 1
        mu, nu = state["mu"], state["nu"]
        for k in mu:
            g = grads[k].to(torch.float32)
            mu[k].mul_(b1).add_(g * (1 - b1))  # b1·m + (1 − b1)·g
            nu[k].mul_(b2).add_(torch.square(g).mul_(1 - b2))  # b2·v + (1 − b2)·g²
        c = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - b1**c)
        nu_hat_scale = 1.0 / (1 - b2**c)
        eta = lr_fn(count)

        def upd(m, v, p):
            step_ = m * mu_hat_scale / (torch.sqrt(v * nu_hat_scale) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(torch.float32)
            return (-eta * step_).to(p.dtype)

        updates = {k: upd(mu[k], nu[k], params[k]) for k in mu}
        return updates, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init=init, update=update)
