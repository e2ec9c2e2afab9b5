"""Decoder-LM assembly over dense ``("attn", "mlp")`` blocks.

Port of ``src/repro/models/model.py``. The model is an :class:`LM`
``nn.Module`` whose ``blocks`` ``nn.ModuleList`` holds every layer in order
(``first_blocks``, then ``pattern`` × ``n_repeats``, then ``tail_blocks``),
in place of the reference's ``lax.scan`` over stacked parameters.
Parameters are stored f32 (``cfg.param_dtype``) and cast to ``cfg.dtype``
at use, as in the reference; they do not require gradients (the serve
path; ``loss_fn`` and the training path are not ported yet, ROADMAP A12).

Entry points:
  * ``forward``     — full-sequence prefill; returns hidden states and the
                      refreshed caches (when given).
  * ``decode_step`` — one token against the caches.

The reference's MoE aux loss is not returned: no MoE block is ported.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rotary import rope_angles

Cache = dict[str, Any]


class LM(nn.Module):
    """Embedding, the blocks in order, the final norm and the (tied or not) head."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: list, lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.ParameterDict({"scale": nn.Parameter(final_norm, requires_grad=False)})
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run yet."""
    cfg.validate()
    missing = [name for name, on in (
        ("the encoder", cfg.encoder is not None), (f"the {cfg.frontend} front end", cfg.frontend),
        ("M-RoPE", cfg.mrope), ("MLA", cfg.mla is not None), ("MoE", cfg.moe is not None),
    ) if on]
    missing += sorted({f"block {kind}" for kind in cfg.all_blocks if tuple(kind) != blk.DENSE})
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported; the port runs dense "
            f"{blk.DENSE} configs (ROADMAP A12)")


def _device(device) -> torch.device:
    """``resolve_device``, plus ``meta`` for building shapes without memory."""
    return torch.device("meta") if str(device) == "meta" else resolve_device(device)


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> LM:
    """Random parameters drawn from a ``torch.Generator`` on ``device``.

    Not bit-equal to the reference's ``init_params`` (jax threefry); parity
    tests carry the reference's parameters across with
    :func:`params_from_numpy`. ``device="meta"`` builds the shapes only.
    """
    check_ported(cfg)
    dev = _device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    embed = torch.randn((v, d), generator=gen, device=dev) * d**-0.5
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = torch.randn((d, v), generator=gen, device=dev) * d**-0.5
    blocks = [blk.init_block(cfg, kind, gen, dev) for kind in cfg.all_blocks]
    return LM(embed, torch.ones((d,), device=dev), blocks, lm_head)


def params_from_numpy(cfg: ModelConfig, params: dict, *, device="cuda") -> LM:
    """The reference's parameter pytree, as numpy arrays, -> an :class:`LM`.

    ``params["stack"]["pos{i}"]`` carries a leading ``n_repeats`` axis; layer
    ``r · period + i`` of the stack is its slice ``[r]``.
    """
    check_ported(cfg)
    dev = resolve_device(device)

    def tensors(tree, index=None):
        if isinstance(tree, dict):
            return {k: tensors(t, index) for k, t in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        return torch.tensor(a if index is None else a[index], device=dev)

    layers = [tensors(p) for p in params["first"]]
    for r in range(cfg.n_repeats):
        layers += [tensors(params["stack"][f"pos{i}"], r) for i in range(len(cfg.pattern))]
    layers += [tensors(p) for p in params["tail"]]
    lm_head = tensors(params["lm_head"]) if "lm_head" in params else None
    return LM(tensors(params["embed"]), tensors(params["final_norm"]["scale"]),
              [blk.as_module(p) for p in layers], lm_head)


def param_count(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


def make_angles(cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    """positions (S,) -> rope angles (S, head_dim // 2)."""
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _embed(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    # the gather commutes with the cast: take(embed.astype(dt)) in the reference
    return F.embedding(tokens, params.embed).to(getattr(torch, cfg.dtype))


def forward(
    cfg: ModelConfig,
    params: LM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    caches: Optional[Cache] = None,
    decode_window: int = 0,
) -> tuple[torch.Tensor, Optional[Cache]]:
    """Returns (hidden (B,S,D), caches')."""
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    angles = make_angles(cfg, torch.arange(s, device=tokens.device))
    new_layers = []
    for i, (kind, block) in enumerate(zip(cfg.all_blocks, params.blocks)):
        c = caches["layers"][i] if caches is not None else None
        x, nc = blk.block_apply(cfg, kind, block, x, angles=angles, mode="full", cache=c,
                                decode_window=decode_window)
        new_layers.append(nc)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    new_caches = None if caches is None else {"layers": new_layers, "pos": s}
    return x, new_caches


def logits_from_hidden(cfg: ModelConfig, params: LM, x: torch.Tensor) -> torch.Tensor:
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head.to(x.dtype)


def decode_step(
    cfg: ModelConfig,
    params: LM,
    token: torch.Tensor,  # (B, 1) int
    caches: Cache,
    *,
    decode_window: int = 0,
) -> tuple[torch.Tensor, Cache]:
    """One-token serve step. Returns (logits (B, V), caches')."""
    pos = caches["pos"]
    x = _embed(cfg, params, token)
    angles = make_angles(cfg, torch.tensor([pos], device=token.device))
    new_layers = []
    for kind, block, c in zip(cfg.all_blocks, params.blocks, caches["layers"]):
        x, nc = blk.block_apply(cfg, kind, block, x, angles=angles, mode="decode", cache=c,
                                decode_window=decode_window)
        new_layers.append(nc)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = logits_from_hidden(cfg, params, x)[:, 0, :]
    return logits, {"layers": new_layers, "pos": pos + 1}


def init_cache(
    cfg: ModelConfig,
    batch: int,
    cache_len: int,
    dtype=None,
    *,
    decode_window: int = 0,
    device="cuda",
) -> Cache:
    """Zero decode-state for every block: ``{"layers": [...], "pos": 0}``."""
    check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    return {
        "layers": [blk.init_block_cache(cfg, kind, batch, cache_len, dtype, dev,
                                        decode_window=decode_window) for kind in cfg.all_blocks],
        "pos": 0,
    }
