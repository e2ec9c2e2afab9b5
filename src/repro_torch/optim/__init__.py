"""Optimizers over dicts of tensors, in ``repro.optim``'s (init, update) shape."""
from repro_torch.optim.base import Optimizer, OptState, apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import constant, cosine_decay, linear_warmup_cosine
from repro_torch.optim.clip import clip_by_global_norm, global_norm

__all__ = [
    "Optimizer",
    "OptState",
    "apply_updates",
    "sgd",
    "adamw",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
    "clip_by_global_norm",
    "global_norm",
]
