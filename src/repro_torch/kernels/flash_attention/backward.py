"""The gradient of the flash-attention route, in torch ops.

The reference has no backward kernel: it differentiates ``attend`` with
XLA. :func:`flash_attention_bwd` is the attention VJP written out, in f32
whatever the inputs' dtype, with the causal mask the kernels apply (query
i sees key j iff j <= i). Per (batch, kv head, group member):

    P  = softmax(hd^-½ · q kᵀ, masked)         recomputed, not saved
    dV = Pᵀ dO
    dS = P ∘ (dO Vᵀ − rowsum(P ∘ dO Vᵀ))       rowsum(P ∘ dO Vᵀ) = rowsum(dO ∘ O)
    dQ = hd^-½ · dS K,   dK = hd^-½ · dSᵀ Q

with dK and dV summed over each GQA group. The rowsum is taken from P
and dO Vᵀ in f32 rather than from the forward's output, which the bf16
kernel has rounded. It holds the (S, T) scores of every head at once:
(B, H, S, T) f32, 268 MB at (4, 16, 1,024, 1,024).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, *, causal: bool = True
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,S,H,hd), k/v (B,T,KV,hd), dout (B,S,H,hd) -> (dq, dk, dv) in
    the dtypes of q, k and v."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd**-0.5
    qf = q.to(torch.float32).reshape(b, s, kv, g, hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    do = dout.to(torch.float32).reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qf, kf) * scale
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        scores = torch.where(mask, scores, NEG)
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bkgst,bskgh->btkh", p, do)
    dp = torch.einsum("bskgh,btkh->bkgst", do, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf) * scale
    return dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
