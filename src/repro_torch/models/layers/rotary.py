"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE.

Port of ``src/repro/models/layers/rotary.py``. The pairs rotated are the
interleaved (x[2i], x[2i+1]), as in the reference, not the half-split
(x[i], x[i + hd/2]) convention. M-RoPE gives each rotation pair one of
three position streams (temporal, height, width) by ``sections``; on text
the three coincide, and its angles are ``rope_angles``' product for
product.
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


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections: tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE: positions (3, ...) t/h/w streams -> angles (..., head_dim//2).

    ``sections`` counts rotation *pairs* per stream and must sum to
    head_dim // 2.
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim//2 = {head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions.device)
    stream_of = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                        torch.tensor(sections, device=positions.device),
                                        output_size=head_dim // 2)  # no sync for the length
    pos_per_band = positions.to(torch.float32)[stream_of]  # (hd//2, ...): each band's stream
    return pos_per_band.movedim(0, -1) * inv


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
