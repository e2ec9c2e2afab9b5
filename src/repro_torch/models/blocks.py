"""Block init/apply for the ported ``(mixer, ffn)`` pairs, pre-norm residuals.

Port of ``src/repro/models/blocks.py``. One block =
    x = x + mixer(rmsnorm(x))        (mixer: GQA attention, sliding-window
                                      "local" attention, MLA, the RG-LRU
                                      recurrent block, mLSTM or sLSTM; in
                                      an encoder, bidirectional attention)
    x = x + cross(rmsnorm(x))        (an encoder-decoder's decoder only:
                                      attention to the encoder's states)
    x = x + ffn(rmsnorm(x))          (ffn: the gated MLP, the MoE FFN, or
                                      "none" — no norm and no parameters)

A block's parameters are an ``nn.ModuleDict`` of ``nn.ParameterDict``s
keyed as the reference's parameter dict (``norm1``, ``attn`` — MLA's
weights too, as there —, ``rec`` for the recurrent mixers, ``cross_norm``
and ``cross`` for cross-attention, ``ffn_norm``, ``mlp`` or ``moe``; the
MoE's ``shared`` experts and MLA's ``kv_norm`` nested ``ParameterDict``s),
so the layer functions index both alike. ``block_apply`` runs in two
modes: ``full`` (train / prefill — whole sequence, seeds the cache; a
recurrent block's cache is its final state; cross-attention projects the
encoder's states into the cache's ``ck`` / ``cv``) and ``decode`` (one
token against the block's cache, cross-attention reading ``ck`` / ``cv``),
and returns the MoE's auxiliary load-balance loss (None for a block
without a MoE). ``PORTED`` lists the decoder's kinds; ``ENCODER`` the
encoder's ``("bidir", "mlp")``, which no decoder layer may be.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import mla as mla_lib
from repro_torch.models.layers import moe as moe_lib
from repro_torch.models.layers import rglru as rglru_lib
from repro_torch.models.layers import xlstm as xlstm_lib
from repro_torch.models.layers.mlp import init_mlp, mlp
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm

DENSE: BlockSpec = ("attn", "mlp")
MOE: BlockSpec = ("attn", "moe")
PORTED = (DENSE, MOE, ("mla", "mlp"), ("mla", "moe"), ("rglru", "mlp"), ("local", "mlp"),
          ("mlstm", "none"), ("slstm", "none"))
ENCODER: BlockSpec = ("bidir", "mlp")
RECURRENT = {
    "rglru": (rglru_lib.init_rglru_block, rglru_lib.rglru_block),
    "mlstm": (xlstm_lib.init_mlstm_block, xlstm_lib.mlstm_block),
    "slstm": (xlstm_lib.init_slstm_block, xlstm_lib.slstm_block),
}


def _check_kind(kind: BlockSpec) -> None:
    if tuple(kind) not in PORTED + (ENCODER,):
        raise NotImplementedError(
            f"block {kind} is not ported; only {', '.join(map(str, PORTED + (ENCODER,)))} are")


def _parameter_dict(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: _parameter_dict(t) if isinstance(t, dict) else nn.Parameter(t, requires_grad=False)
        for k, t in tree.items()
    })


def as_module(params: dict) -> nn.ModuleDict:
    """A block's nested dict of tensors -> ``ModuleDict`` of ``ParameterDict``s
    (a dict inside a sub-dict, the MoE's ``shared``, a nested ``ParameterDict``).

    The parameters are made with ``requires_grad`` off (the serve path); a
    trainer turns it on for the whole model (``LM.requires_grad_``).
    """
    return nn.ModuleDict({name: _parameter_dict(sub) for name, sub in params.items()})


def init_block(cfg: ModelConfig, kind: BlockSpec, gen: Optional[torch.Generator], device, *,
               cross: bool = False) -> nn.ModuleDict:
    """A block's parameters; ``cross`` adds cross-attention (``cross_norm``,
    ``cross``: an attention's weights), as an encoder-decoder's decoder has."""
    _check_kind(kind)
    mixer, ffn = kind
    p = {"norm1": init_rmsnorm(cfg.d_model, device=device)}
    if mixer in RECURRENT:
        p["rec"] = RECURRENT[mixer][0](cfg, gen, device)
    else:
        init_mixer = mla_lib.init_mla if mixer == "mla" else attn_lib.init_attention
        p["attn"] = init_mixer(cfg, gen, device)
    if cross:
        p["cross_norm"] = init_rmsnorm(cfg.d_model, device=device)
        p["cross"] = attn_lib.init_attention(cfg, gen, device)
    if ffn != "none":
        p["ffn_norm"] = init_rmsnorm(cfg.d_model, device=device)
    if ffn == "moe":
        p["moe"] = moe_lib.init_moe(cfg, gen, device)
    elif ffn == "mlp":
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, gen, device)
    return as_module(p)


def init_block_cache(
    cfg: ModelConfig, kind: BlockSpec, batch: int, cache_len: int, dtype, device,
    *, decode_window: int = 0, cross_len: int = 0,
) -> dict:
    """Decode-state for one block. ``decode_window`` ring-buffers 'attn'
    blocks; a 'local' block's ring holds ``cfg.sliding_window`` entries at
    most; an MLA cache takes the whole ``cache_len``, as the reference's; a
    recurrent block's cache is its zero state. ``cross_len`` adds
    cross-attention's ``ck`` / ``cv`` of (B, cross_len, KV, hd)."""
    _check_kind(kind)
    mixer = kind[0]
    if mixer == "mla":
        cache = mla_lib.init_mla_cache(cfg, batch, cache_len, dtype, device)
    elif mixer == "rglru":
        cache = rglru_lib.init_rglru_state(cfg, batch, dtype, device)
    elif mixer == "mlstm":
        cache = xlstm_lib.init_mlstm_state(cfg, batch, device)
    elif mixer == "slstm":
        cache = xlstm_lib.init_slstm_state(cfg, batch, device)
    else:
        if mixer == "local":
            length = min(cache_len, cfg.sliding_window)
        else:
            length = min(cache_len, decode_window) if decode_window else cache_len
        cache = attn_lib.init_kv_cache(cfg, batch, length, dtype, device)
    if cross_len:
        shape = (batch, cross_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["ck"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cv"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _mixer_window(cfg: ModelConfig, mixer: str, decode_window: int) -> int:
    """The window of a mixer: ``cfg.sliding_window`` for "local" (its
    prefill mask and its decode ring), ``decode_window`` for "attn", 0
    otherwise (the encoder's "bidir" sees every frame)."""
    if mixer == "local":
        return cfg.sliding_window
    return decode_window if mixer == "attn" else 0


def block_apply(
    cfg: ModelConfig,
    kind: BlockSpec,
    params: nn.ModuleDict,
    x: torch.Tensor,
    *,
    angles: Optional[torch.Tensor],
    mode: str,  # 'full' | 'decode'
    cache: Optional[dict] = None,
    enc_out: Optional[torch.Tensor] = None,
    decode_window: int = 0,
) -> tuple[torch.Tensor, Optional[dict], Optional[torch.Tensor]]:
    """Returns (x, new_cache, aux_loss); the aux loss is None for a block
    without a MoE. A block with cross-attention needs ``enc_out`` (the
    encoder's states) in full mode; in decode it reads the cache's
    ``ck`` / ``cv``."""
    _check_kind(kind)
    mixer, ffn = kind
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    window = _mixer_window(cfg, mixer, decode_window)
    new_cache = cache
    if mixer in RECURRENT:
        y, st = RECURRENT[mixer][1](cfg, params["rec"], h, None if mode == "full" else cache)
        new_cache = None if cache is None else st
    elif mixer == "mla":
        y, new_cache = _mla(cfg, params["attn"], h, angles, mode, cache)
    elif mode == "full":
        y, kv = attn_lib.attention_full(cfg, params["attn"], h, angles, window=window,
                                        bidirectional=mixer == "bidir")
        if cache is not None:  # a cross-attention block's ck / cv stay in the dict
            new_cache = {**cache, **pack_kv_cache(kv, cache["k"].shape[1], window, cache["k"].dtype)}
    else:
        y, upd = attn_lib.attention_decode(cfg, params["attn"], h, angles, cache, window=window)
        new_cache = {**cache, **upd}
    x = x + y
    if "cross" in params:
        x, new_cache = _cross(cfg, params, x, mode, new_cache, enc_out)
    if ffn == "none":
        return x, new_cache, None
    hf = rmsnorm(params["ffn_norm"], x, cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe_lib.moe_ffn(cfg, params["moe"], hf)
        return x + y, new_cache, aux
    return x + mlp(cfg, params["mlp"], hf), new_cache, None


def _cross(cfg: ModelConfig, params, x: torch.Tensor, mode: str, cache: Optional[dict],
           enc_out: Optional[torch.Tensor]):
    """Cross-attention to the encoder's states, no mask: in full mode their
    k / v come from ``enc_out`` (and are written into the cache, if one is
    given), in decode from the cache, cast to the activation dtype. As in
    the reference, the query comes out of ``qkv`` with no angles."""
    hc = rmsnorm(params["cross_norm"], x, cfg.norm_eps)
    q, _, _ = attn_lib.qkv(cfg, params["cross"], hc, None)
    if mode == "full":
        if enc_out is None:
            raise ValueError("encoder output required for full-mode cross-attention")
        ck, cv = cross_kv(cfg, params["cross"], enc_out)
        if cache is not None:
            cache = {**cache, "ck": ck.to(cache["ck"].dtype), "cv": cv.to(cache["cv"].dtype)}
    else:
        ck, cv = cache["ck"].to(x.dtype), cache["cv"].to(x.dtype)
    y = attn_lib.attend(cfg, q, ck, cv, None) @ params["cross"]["wo"].to(x.dtype)
    return x + y, cache


def cross_kv(cfg: ModelConfig, params, enc_out: torch.Tensor):
    """Project encoder output to cross-attention k/v (no rope, no qk-norm)."""
    b, f, _ = enc_out.shape
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = enc_out.dtype
    k = (enc_out @ params["wk"].to(dt)).reshape(b, f, kvh, hd)
    v = (enc_out @ params["wv"].to(dt)).reshape(b, f, kvh, hd)
    if cfg.qkv_bias:
        k = k + params["bk"].to(dt).reshape(kvh, hd)
        v = v + params["bv"].to(dt).reshape(kvh, hd)
    return k, v


def _mla(cfg: ModelConfig, params, h: torch.Tensor, angles, mode: str, cache: Optional[dict]):
    """MLA in either mode. A prefill writes its latent and rotary key into
    the cache at [0, S) and sets ``pos`` to S (in place, as decode does)."""
    if mode != "full":
        return mla_lib.mla_decode(cfg, params, h, angles, cache)
    y, seed = mla_lib.mla_full(cfg, params, h, angles)
    if cache is None:
        return y, None
    s = seed["c"].shape[1]
    cache["c"][:, :s] = seed["c"].to(cache["c"].dtype)
    cache["k_rope"][:, :s] = seed["k_rope"].to(cache["k_rope"].dtype)
    return y, {"c": cache["c"], "k_rope": cache["k_rope"], "pos": s}


def pack_kv_cache(kv: dict, cache_len: int, window: int, dtype) -> dict:
    """Seed a decode cache from prefill k/v (ring-rolled for windowed caches).

    Ring invariant: slot ``p % window`` holds position ``p``. After a prefill
    of length S the last ``window`` positions S-w..S-1 land at slots
    ``(S-w+i) % w`` — i.e. the chronological tail rolled by ``S % w``.
    """
    k, v = kv["k"], kv["v"]
    s = k.shape[1]
    if window and s > window:
        shift = s % window
        k = torch.roll(k[:, -window:], shift, dims=1)
        v = torch.roll(v[:, -window:], shift, dims=1)
        pad = 0
    else:
        pad = cache_len - s

    def seed(u):
        out = torch.zeros((u.shape[0], u.shape[1] + max(pad, 0)) + tuple(u.shape[2:]),
                          dtype=dtype, device=u.device)
        out[:, : u.shape[1]] = u
        return out

    return {"k": seed(k), "v": seed(v), "pos": s}
