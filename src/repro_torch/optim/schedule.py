"""Learning-rate schedules.

Port of ``src/repro/optim/schedule.py``. A schedule maps a step count (an
int or an integer tensor, such as AdamW's ``count`` on the device) to an
f32 0-d tensor on the step's device, computed in f32 as the reference
computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def cosine_decay(lr: float, total_steps: int, final_scale: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_scale + (1 - final_scale) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_scale: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_scale)

    def fn(step):
        step = torch.as_tensor(step)
        warm = lr * _f32(step) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
