"""Normalization layers (functional).

Port of ``src/repro/models/layers/norms.py``: each computes in f32 and casts
back to the input's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_or_meta


def init_rmsnorm(dim: int, *, device="cuda") -> dict:
    """An RMS norm's parameters: a unit f32 scale (``device="meta"``: its
    shape only)."""
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=resolve_or_meta(device))}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 / torch.sqrt(var + eps)
    return (out * params["scale"]).to(x.dtype)


def init_layernorm(dim: int, *, device="cuda") -> dict:
    """A layer norm's parameters: a unit f32 scale and a zero f32 bias."""
    dev = resolve_or_meta(device)
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=dev),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=dev)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) / torch.sqrt(var + eps)
    return (out * params["scale"] + params["bias"]).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over the trailing head_dim (Qwen3 qk-norm)."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 / torch.sqrt(var + eps) * scale).to(x.dtype)
