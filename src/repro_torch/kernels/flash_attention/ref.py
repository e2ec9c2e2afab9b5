"""Plain PyTorch versions of the flash-attention kernel.

:func:`flash_attention_plain` computes the CUDA kernels' function (the bf16
tensor-core kernel's and the f32 CUDA-core kernel's); the wrapper in
``ops.py`` runs it for CPU tensors, and the card checks hold both kernels
against it. :func:`attention_ref` is a copy of the reference's oracle
(``src/repro/kernels/flash_attention/ref.py``), for the CPU parity tests.
"""
from __future__ import annotations

import torch

NEG = -1.0e30  # the kernel's finite mask value (never -inf)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd) in q's dtype.

    Scores in f32 from upcast q and k, scaled by hd^-½ after the dot; query
    i sees key j iff j <= i (causal). p = exp(s − max) is summed in f32 for
    the denominator, cast to v's dtype for the PV product, which runs in
    f32; the output is divided by max(l, 1e-30) and cast once.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.to(torch.float32).reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(torch.float32)) * hd**-0.5
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        scores = torch.where(mask, scores, NEG)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = p.to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgst,btkh->bskgh", pv, v.to(torch.float32))
    out = out / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd), f32 softmax."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32) * hd**-0.5
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(b, s, h, hd)
