"""SGD with optional momentum — the paper's client-side optimizer.

Port of ``src/repro/optim/sgd.py``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer, as_schedule


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = as_schedule(lr)

    if momentum == 0.0:

        def init(params):
            return ()

        def update(grads, state, params, step):
            del params
            eta = lr_fn(step)
            return {k: -eta * g for k, g in grads.items()}, state

    else:

        def init(params):
            return {k: torch.zeros_like(p) for k, p in params.items()}

        def update(grads, state, params, step):
            del params
            eta = lr_fn(step)
            new_v = {k: momentum * state[k] + g for k, g in grads.items()}
            return {k: -eta * v for k, v in new_v.items()}, new_v

    return Optimizer(init=init, update=update)
