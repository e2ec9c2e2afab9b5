"""Gated (SwiGLU/GeGLU) and plain MLP blocks.

Port of ``src/repro/models/layers/mlp.py``. Weights are stored f32 and cast
to the activation dtype at use.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

# jax.nn.gelu defaults to the tanh approximation
ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu}


def init_mlp(d_model: int, d_ff: int, gen: Optional[torch.Generator], device, *,
             gated: bool = True) -> dict:
    """The MLP's weights: ``w_up`` and ``w_down``, and with ``gated`` (the
    default, as in the reference) ``w_gate``, which :func:`mlp` reads as the
    gated form."""
    s_in, s_out = d_model**-0.5, d_ff**-0.5
    p = {
        "w_up": torch.randn((d_model, d_ff), generator=gen, device=device) * s_in,
        "w_down": torch.randn((d_ff, d_model), generator=gen, device=device) * s_out,
    }
    if gated:
        p["w_gate"] = torch.randn((d_model, d_ff), generator=gen, device=device) * s_in
    return p


def mlp(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    act = ACTS[cfg.act]
    dt = x.dtype
    up = x @ params["w_up"].to(dt)
    if "w_gate" in params:
        up = act(x @ params["w_gate"].to(dt)) * up
    else:
        up = act(up)
    return up @ params["w_down"].to(dt)
