"""Minimal optax-style optimizer core over dicts of tensors.

Port of ``src/repro/optim/base.py``. An :class:`Optimizer` is an
``(init, update)`` pair:
  state = opt.init(params)
  updates, state = opt.update(grads, state, params, step)
  params = apply_updates(params, updates)
Parameters may carry a leading client axis; every rule is elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

OptState = Any
Schedule = Callable[[Any], Any]  # step -> lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], OptState]
    update: Callable[[dict, OptState, dict, Any], tuple[dict, OptState]]


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: lr
