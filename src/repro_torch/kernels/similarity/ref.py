"""Plain PyTorch versions of the similarity kernel and its epilogue.

``gram_ref`` and ``l1_ref`` are what ``ops.pairwise_sums`` computes for a
CPU tensor; on the card ``chip_smoke.py`` holds the CUDA kernel against
them. ``distances_from_gram`` is the arccos / l2 epilogue of
``src/repro/kernels/similarity/ref.py`` and runs on the device for both.
"""
from __future__ import annotations

import torch

#: rows of G per step of ``l1_ref``, bounding its (rows, n, d) temporary
L1_REF_ROWS = 16


def gram_ref(G: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) G Gᵀ in f32."""
    G = G.to(torch.float32)
    return G @ G.T


def l1_ref(G: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) Σ_k |G_ik − G_jk| in f32."""
    G = G.to(torch.float32)
    rows = [
        (G[lo : lo + L1_REF_ROWS, None, :] - G[None, :, :]).abs().sum(dim=-1)
        for lo in range(0, G.shape[0], L1_REF_ROWS)
    ]
    return torch.cat(rows)


def distances_from_gram(gram: torch.Tensor, measure: str) -> torch.Tensor:
    """Derive arccos / l2 distances from the Gram matrix (f32, symmetric)."""
    sq = torch.diagonal(gram)
    if measure == "l2":
        d2 = sq[:, None] + sq[None, :] - 2.0 * gram
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
    elif measure == "arccos":
        norms = torch.sqrt(torch.clamp(sq, min=0.0))
        safe = torch.where(norms > 0, norms, torch.ones_like(norms))
        cos = gram / (safe[:, None] * safe[None, :])
        zero = norms == 0
        both = zero[:, None] & zero[None, :]
        either = zero[:, None] ^ zero[None, :]
        cos = torch.where(both, torch.ones_like(cos), cos)
        cos = torch.where(either, torch.zeros_like(cos), cos)
        dist = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    else:
        raise ValueError(measure)
    return _zero_diag_symmetrize(dist)


def _zero_diag_symmetrize(dist: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(dist.shape[0], dtype=torch.bool, device=dist.device)
    dist = torch.where(eye, torch.zeros_like(dist), dist)
    return torch.maximum(dist, dist.T)
