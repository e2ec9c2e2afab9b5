"""GQA attention: full / sliding-window, qk-norm, QKV-bias.

Port of ``src/repro/models/layers/attention.py``. A causal, unwindowed,
un-softcapped full pass goes through the flash-attention kernel (B4),
which computes what :func:`attend` computes there, with its gradient from
``kernels/flash_attention/backward.py``; every other case, and decode,
goes through :func:`attend` — the sliding-window "local" mixer among them
(recurrentgemma's, head dim 256), whose window ``blocks._mixer_window``
sets, and whisper's bidirectional encoder and its decoder's
cross-attention (``blocks._cross``), as the reference's model sends them
there too. With ``cfg.attn_block_q > 0`` the full pass takes the
reference's blockwise path instead: each block of that many query rows is
:func:`attend` against every key under its own mask, inside
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a
block's (bq, S) scores are all the pass keeps, the backward recomputing
them; the numerics are :func:`attend`'s over the whole sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.norms import rms_head_norm
from repro_torch.models.layers.rotary import apply_rope

NEG_INF = -2.0e38


def init_attention(cfg: ModelConfig, gen: Optional[torch.Generator], device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    p = {
        "wq": normal((d, h * hd), d**-0.5),
        "wk": normal((d, kv * hd), d**-0.5),
        "wv": normal((d, kv * hd), d**-0.5),
        "wo": normal((h * hd, d), (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((width,), device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device)
        p["k_norm"] = torch.ones((hd,), device=device)
    return p


def qkv(cfg: ModelConfig, params, x: torch.Tensor, angles: Optional[torch.Tensor]):
    """Project + normalize + rotate. x: (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    wdt = x.dtype
    q = x @ params["wq"].to(wdt)
    k = x @ params["wk"].to(wdt)
    v = x @ params["wv"].to(wdt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(wdt)
        k = k + params["bk"].to(wdt)
        v = v + params["bv"].to(wdt)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_head_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(params["k_norm"], k, cfg.norm_eps)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def attend(
    cfg: ModelConfig,
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,  # (B, T, KV, hd)
    mask: Optional[torch.Tensor],  # (S, T) or (B, S, T) bool, True = attend
) -> torch.Tensor:
    """Grouped-query scaled dot-product attention, f32 softmax.

    As in the reference, the scores come out of the einsum in the input
    dtype (bf16 rounds them) before the f32 softmax.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32) * (hd**-0.5)
    if cfg.logit_softcap:
        scores = cfg.logit_softcap * torch.tanh(scores / cfg.logit_softcap)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = torch.where(m[:, None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(b, s, h * hd)


def causal_mask(s: int, t: int, offset: int, window: int = 0, device=None) -> torch.Tensor:
    """(s, t) mask; query i sits at absolute position offset + i.

    ``window > 0`` additionally bounds lookback (sliding window): key j is
    visible iff q_pos - window < j <= q_pos.
    """
    q_pos = offset + torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    m = k_pos <= q_pos
    if window > 0:
        m &= k_pos > q_pos - window
    return m


def attention_full(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,
    angles: Optional[torch.Tensor],
    *,
    window: int = 0,
    bidirectional: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Training/prefill attention over the whole sequence.

    Returns (output (B,S,D), kv dict for cache construction).
    """
    b, s, _ = x.shape
    q, k, v = qkv(cfg, params, x, angles)
    bq = cfg.attn_block_q
    if not bidirectional and window == 0 and not cfg.logit_softcap and not bq:
        out = flash_attention(q, k, v, causal=True).reshape(b, s, -1)
    elif bq and s % bq == 0 and s > bq:
        # a Python loop over the query blocks, as the reference's static loop

        def one_block(qi, off):
            mi = None if bidirectional else causal_mask(bq, s, off, window, device=x.device)
            return attend(cfg, qi, k, v, mi)

        out = torch.cat([checkpoint(one_block, q[:, i : i + bq], i, use_reentrant=False)
                         for i in range(0, s, bq)], dim=1)
    else:
        mask = None if bidirectional else causal_mask(s, s, 0, window, device=x.device)
        out = attend(cfg, q, k, v, mask)
    y = out @ params["wo"].to(x.dtype)
    return y, {"k": k, "v": v}


def attention_decode(
    cfg: ModelConfig,
    params,
    x: torch.Tensor,  # (B, 1, D)
    angles: Optional[torch.Tensor],  # (1, hd//2) for the current position
    cache: dict,  # {"k": (B, C, KV, hd), "v": ..., "pos": int}
    *,
    window: int = 0,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode against a (possibly ring-buffered) KV cache.

    ``window > 0`` means the cache is a ring buffer of that length; the new
    entry lands at ``pos % window`` and all slots are attendable. For full
    caches the new entry lands at ``pos`` and slots ``> pos`` are masked
    out. Unlike the reference, which returns new arrays, the new entry is
    written into the cache's tensors in place (no copy of the cache per
    token); the returned dict holds the same tensors.
    """
    q, k_new, v_new = qkv(cfg, params, x, angles)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    slot = pos % window if window > 0 else pos
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    mask = (torch.arange(k.shape[1], device=x.device) <= pos)[None, :]  # (1, C)
    out = attend(cfg, q, k.to(x.dtype), v.to(x.dtype), mask)
    y = out @ params["wo"].to(x.dtype)
    return y, {"k": k, "v": v, "pos": pos + 1}


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cache_len, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, kvh, hd), dtype=dtype, device=device),
        "pos": 0,
    }
