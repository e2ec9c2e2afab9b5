"""Plain PyTorch version of the aggregate kernel."""
from __future__ import annotations

import torch


def aggregate_ref(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(k, p), (k,) -> (p,) Σ_k w_k U_k in f32, rows added in order."""
    updates = updates.to(torch.float32)
    weights = weights.to(torch.float32)
    out = torch.zeros(updates.shape[1], dtype=torch.float32, device=updates.device)
    for k in range(updates.shape[0]):
        out = out + weights[k] * updates[k]
    return out
