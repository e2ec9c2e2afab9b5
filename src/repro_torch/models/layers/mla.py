"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of ``src/repro/models/layers/mla.py``. KV activations are compressed
into a shared ``kv_lora_rank`` latent ``c`` plus one shared rotary key
head; per-head keys and values are up-projected from ``c``. The decode
cache holds only ``{"c", "k_rope", "pos"}`` (576 values a token at
deepseek-v2-lite's widths), with ``pos`` a Python int as in the port's KV
caches.

The attention is the reference's own einsums, computed outside any Pallas
kernel there, so it stays torch ops here: the qk head dim (nope + rope,
192 at full width) differs from the v head dim (128), which the flash
kernel (B4) does not take. The casts follow the reference's: each score
einsum runs in the compute dtype (so a bf16 run rounds it to bf16), then
f32 for the sum of its two parts, the scale and the softmax, then v's
dtype.

Two decode paths (``cfg.mla.decode_mode``):
  * ``naive``    — re-expand k / v from the cached latent every step;
  * ``absorbed`` — fold W_UK into the query and W_UV into the output, so
    attention runs in latent space (the same function).
As the port's ``attention_decode``, decode writes the new entry into the
cache's tensors in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.attention import NEG_INF, causal_mask
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.models.layers.rotary import apply_rope


def init_mla(cfg: ModelConfig, gen: Optional[torch.Generator], device) -> dict:
    """The reference's leaves and scales, drawn from ``gen``."""
    mla = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = mla.nope_head_dim + mla.rope_head_dim
    r = mla.kv_lora_rank

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    return {
        "wq": normal((d, h * qd), d**-0.5),
        "w_dkv": normal((d, r), d**-0.5),
        "w_kr": normal((d, mla.rope_head_dim), d**-0.5),
        "kv_norm": init_rmsnorm(r, device=device),
        "w_uk": normal((r, h, mla.nope_head_dim), r**-0.5),
        "w_uv": normal((r, h, mla.v_head_dim), r**-0.5),
        "wo": normal((h * mla.v_head_dim, d), (h * mla.v_head_dim) ** -0.5),
    }


def _mla_q(cfg: ModelConfig, params, x: torch.Tensor, angles: torch.Tensor):
    """x (B, S, D) -> q_nope (B, S, H, nd), q_rope (B, S, H, rd) rotated."""
    mla = cfg.mla
    b, s, _ = x.shape
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, -1)
    q_nope, q_rope = q[..., : mla.nope_head_dim], q[..., mla.nope_head_dim:]
    return q_nope, apply_rope(q_rope, angles)


def _mla_latent(cfg: ModelConfig, params, x: torch.Tensor, angles: torch.Tensor):
    """Compressed latent and the shared rotary key: c (B, S, R), k_rope (B, S, rd)."""
    c = rmsnorm(params["kv_norm"], x @ params["w_dkv"].to(x.dtype), cfg.norm_eps)
    k_rope = x @ params["w_kr"].to(x.dtype)  # one head, shared by all
    return c, apply_rope(k_rope[:, :, None, :], angles)[:, :, 0, :]


def _scores(cfg: ModelConfig, nope: torch.Tensor, rope: torch.Tensor, mask) -> torch.Tensor:
    """The two score parts (B, H, S, T), each in the compute dtype, summed,
    scaled and masked in f32, then the softmax."""
    mla = cfg.mla
    scores = nope.to(torch.float32) + rope.to(torch.float32)
    scores = scores * (mla.nope_head_dim + mla.rope_head_dim) ** -0.5
    if mask is not None:
        scores = torch.where(mask[:, None] if mask.dim() == 3 else mask[None, None], scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def _mla_attend(cfg, q_nope, q_rope, k_nope, k_rope, v, mask) -> torch.Tensor:
    """q_nope (B,S,H,nd), k_nope (B,T,H,nd), k_rope (B,T,rd) the shared head."""
    p = _scores(cfg, torch.einsum("bshd,bthd->bhst", q_nope, k_nope),
                torch.einsum("bshd,btd->bhst", q_rope, k_rope), mask).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", p, v)


def mla_full(cfg: ModelConfig, params, x: torch.Tensor, angles: torch.Tensor):
    """Training / prefill. Returns (y (B, S, D), the cache seed {c, k_rope})."""
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(cfg, params, x, angles)
    c, k_rope = _mla_latent(cfg, params, x, angles)
    k_nope = torch.einsum("btr,rhd->bthd", c, params["w_uk"].to(x.dtype))
    v = torch.einsum("btr,rhd->bthd", c, params["w_uv"].to(x.dtype))
    out = _mla_attend(cfg, q_nope, q_rope, k_nope, k_rope, v,
                      causal_mask(s, s, 0, device=x.device))
    y = out.reshape(b, s, -1) @ params["wo"].to(x.dtype)
    return y, {"c": c, "k_rope": k_rope}


def mla_decode(cfg: ModelConfig, params, x: torch.Tensor, angles, cache: dict):
    """One token (B, 1, D) against the compressed cache {c, k_rope, pos}."""
    mla = cfg.mla
    b = x.shape[0]
    pos = cache["pos"]
    q_nope, q_rope = _mla_q(cfg, params, x, angles)
    c_new, kr_new = _mla_latent(cfg, params, x, angles)
    c, k_rope = cache["c"], cache["k_rope"]
    c[:, pos] = c_new[:, 0].to(c.dtype)
    k_rope[:, pos] = kr_new[:, 0].to(k_rope.dtype)
    mask = (torch.arange(c.shape[1], device=x.device) <= pos)[None, :]  # (1, T)
    cdt, krdt = c.to(x.dtype), k_rope.to(x.dtype)
    w_uk, w_uv = params["w_uk"].to(x.dtype), params["w_uv"].to(x.dtype)
    if mla.decode_mode == "absorbed":
        # W_UK folded into q, W_UV into the output: attention in latent space
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        p = _scores(cfg, torch.einsum("bshr,btr->bhst", q_lat, cdt),
                    torch.einsum("bshd,btd->bhst", q_rope, krdt), mask).to(x.dtype)
        lat_out = torch.einsum("bhst,btr->bshr", p, cdt)  # (B, 1, H, R)
        out = torch.einsum("bshr,rhd->bshd", lat_out, w_uv)
    else:
        k_nope = torch.einsum("btr,rhd->bthd", cdt, w_uk)
        v = torch.einsum("btr,rhd->bthd", cdt, w_uv)
        out = _mla_attend(cfg, q_nope, q_rope, k_nope, krdt, v, mask)
    y = out.reshape(b, 1, -1) @ params["wo"].to(x.dtype)
    return y, {"c": c, "k_rope": k_rope, "pos": pos + 1}


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, device) -> dict:
    mla = cfg.mla
    return {
        "c": torch.zeros((batch, cache_len, mla.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, mla.rope_head_dim), dtype=dtype, device=device),
        "pos": 0,
    }
