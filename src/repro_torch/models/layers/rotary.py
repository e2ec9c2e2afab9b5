"""Rotary position embeddings.

Port of ``src/repro/models/layers/rotary.py``. The pairs rotated are the
interleaved (x[2i], x[2i+1]), as in the reference, not the half-split
(x[i], x[i + hd/2]) convention.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for each rotation pair, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., head_dim//2) in float32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions.to(torch.float32)[..., None] * inv


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs. x: (..., S, n_heads, head_dim); angles: (..., S, head_dim//2)."""
    x32 = x.to(torch.float32)
    x1 = x32[..., 0::2]
    x2 = x32[..., 1::2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)
