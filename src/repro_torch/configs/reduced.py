# Copied from src/repro/configs/reduced.py.
"""Reduced variants of each architecture family for CPU smoke tests.

Per the brief: <= 2-ish layers (one period + required first/tail structure),
d_model <= 512, <= 4 experts; same family/block structure as the full config
so the smoke test exercises the identical code path.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import EncoderConfig, MLAConfig, ModelConfig, MoEConfig


def make_reduced(cfg: ModelConfig, *, d_model: int = 128, vocab: int = 512) -> ModelConfig:
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    head_dim = 32 if cfg.head_dim else 0
    # one period + structural prefix/suffix
    n_layers = len(cfg.first_blocks) + len(cfg.pattern) + len(cfg.tail_blocks)

    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, n_routed=4, n_shared=min(moe.n_shared, 1), top_k=2,
            d_ff_expert=64, group_size=64, capacity_factor=2.0,
        )
    mla = cfg.mla
    if mla is not None:
        mla = dataclasses.replace(
            mla, kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32, v_head_dim=32
        )
    enc = cfg.encoder
    if enc is not None:
        enc = EncoderConfig(n_layers=2, n_frames=16)

    hd = head_dim or d_model // n_heads
    sections = (hd // 2 - 2 * (hd // 6), hd // 6, hd // 6)  # t/h/w pairs, sums to hd//2

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=vocab,
        sliding_window=16,
        mrope_sections=sections,
        moe=moe,
        mla=mla,
        encoder=enc,
        n_vision_tokens=4,
        dtype="float32",  # CPU numerics for smoke assertions
        remat=False,
    )
