"""Decoder-LM / encoder-decoder assembly over the ported blocks.

Port of ``src/repro/models/model.py``. The model is an :class:`LM`
``nn.Module`` whose ``blocks`` ``nn.ModuleList`` holds every layer in order
(``first_blocks``, then ``pattern`` × ``n_repeats``, then ``tail_blocks``),
in place of the reference's ``lax.scan`` over stacked parameters. An
encoder-decoder (whisper) has an :class:`Encoder` too: its ``("bidir",
"mlp")`` blocks and final norm, run over the stubbed front end's frames
with sinusoidal positions (:func:`encode`); its decoder's blocks carry
cross-attention, and its decoder adds sinusoidal positions in place of
rotary angles. A VLM (qwen2-vl) takes precomputed vision embeddings in the
leading token slots and rotates with M-RoPE (t = h = w on text).
Parameters are stored f32 (``cfg.param_dtype``) and cast to ``cfg.dtype``
at use, as in the reference. They are made with ``requires_grad`` off, for
the serve path; a trainer turns it on (``LM.requires_grad_``). With
``cfg.remat`` and gradients on, each block runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the scan
body): its activations are recomputed in the backward pass.

Entry points:
  * ``forward``     — full-sequence train / prefill; returns hidden states,
                      the refreshed caches (when given) and the MoE aux
                      loss (the sum over MoE blocks; zero without one).
                      ``vision_embeds`` / ``frames`` are the front ends'
                      stubbed outputs.
  * ``decode_step`` — one token (or ``input_embed``) against the caches.
  * ``loss_fn``     — next-token CE plus ``aux_weight`` × the aux loss;
                      ``cfg.fused_ce`` computes the CE in sequence chunks
                      without the (B, S, V) logits.

As in the reference, ``loss_fn`` without ``frames`` fails on whisper at
``encode`` with an ``AttributeError``; the federated LM's local step calls
it so, and so raises on whisper in both packages (ROADMAP, "Known state").

:func:`params_from_numpy` takes the reference's stacked parameter pytree;
:func:`params_to_numpy` and :func:`reference_tree` give it back, and
:func:`reference_leaves` lists the port's tensors in its ``tree_leaves``
order; :func:`flatten_lm` lays an LM out as one flat vector in that order
and :func:`lm_views` makes an LM of views into such a vector.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, resolve_or_meta
from repro_torch.models import blocks as blk
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.models.layers.rotary import mrope_angles, rope_angles

# the reference's parameter pytree; the port keeps its parameters in an LM
Params = dict[str, Any]
Cache = dict[str, Any]


Layout = tuple[int, int, int, int]


def stack_layout(cfg: ModelConfig) -> Layout:
    """(first blocks, pattern period, repeats, tail blocks) of ``cfg``."""
    return len(cfg.first_blocks), len(cfg.pattern), cfg.n_repeats, len(cfg.tail_blocks)


def _norm(scale: torch.Tensor) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": nn.Parameter(scale, requires_grad=False)})


class Encoder(nn.Module):
    """A whisper-style encoder: its ``blocks.ENCODER`` blocks in order and
    its final norm (the reference's ``params["encoder"]``, whose
    ``stack/pos0`` leaves stack the blocks)."""

    def __init__(self, final_norm: torch.Tensor, blocks: list):
        super().__init__()
        self.final_norm = _norm(final_norm)
        self.blocks = nn.ModuleList(blocks)


class LM(nn.Module):
    """Embedding, the blocks in order, the final norm and the (tied or not)
    head, and an encoder-decoder's :class:`Encoder` (None otherwise).

    ``layout`` is :func:`stack_layout` of the config: which blocks are the
    reference's ``first``, ``stack/pos{i}`` slices and ``tail``.
    """

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 blocks: list, lm_head: Optional[torch.Tensor] = None, *, layout: Layout,
                 encoder: Optional[Encoder] = None):
        super().__init__()
        nf, period, reps, nt = layout
        if nf + period * reps + nt != len(blocks):
            raise ValueError(f"layout {layout} does not cover {len(blocks)} blocks")
        self.layout = tuple(layout)
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = _norm(final_norm)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.encoder = encoder


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config with a decoder block kind
    the port does not run (every one of the reference's configs runs)."""
    cfg.validate()
    missing = sorted({str(kind) for kind in cfg.all_blocks if tuple(kind) not in blk.PORTED})
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: decoder block {', '.join(missing)} not ported; the port's decoder runs "
            f"{', '.join(map(str, blk.PORTED))} blocks")


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> LM:
    """Random parameters drawn from a ``torch.Generator`` on ``device``.

    Not bit-equal to the reference's ``init_params`` (jax threefry); parity
    tests carry the reference's parameters across with
    :func:`params_from_numpy`. ``device="meta"`` builds the shapes only.
    """
    check_ported(cfg)
    dev = resolve_or_meta(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    embed = torch.randn((v, d), generator=gen, device=dev) * d**-0.5
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = torch.randn((d, v), generator=gen, device=dev) * d**-0.5
    cross = cfg.encoder is not None
    blocks = [blk.init_block(cfg, kind, gen, dev, cross=cross) for kind in cfg.all_blocks]
    encoder = None
    if cross:
        encoder = Encoder(init_rmsnorm(d, device=dev)["scale"],
                          [blk.init_block(cfg, blk.ENCODER, gen, dev) for _ in range(cfg.encoder.n_layers)])
    return LM(embed, init_rmsnorm(d, device=dev)["scale"], blocks, lm_head, layout=stack_layout(cfg),
              encoder=encoder)


def params_from_numpy(cfg: ModelConfig, params: dict, *, device="cuda") -> LM:
    """The reference's parameter pytree, as numpy arrays, -> an :class:`LM`.

    ``params["stack"]["pos{i}"]`` carries a leading ``n_repeats`` axis; layer
    ``r · period + i`` of the stack is its slice ``[r]``; encoder block ``i``
    is ``params["encoder"]["stack"]["pos0"]``'s slice ``[i]``.
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
    encoder = None
    if "encoder" in params:
        enc = params["encoder"]
        encoder = Encoder(tensors(enc["final_norm"]["scale"]),
                          [blk.as_module(tensors(enc["stack"]["pos0"], i))
                           for i in range(cfg.encoder.n_layers)])
    return LM(tensors(params["embed"]), tensors(params["final_norm"]["scale"]),
              [blk.as_module(p) for p in layers], lm_head, layout=stack_layout(cfg),
              encoder=encoder)


def reference_leaves(params: LM) -> list[tuple[tuple[str, ...], list[str]]]:
    """(reference path, the port's parameter names) for each leaf of the
    reference's stacked tree, in its ``jax.tree_util`` order: dict keys
    sorted, ``first`` / ``tail`` by index. A ``stack/pos{i}`` leaf lists
    its ``n_repeats`` layers in order (its leading axis), an
    ``encoder/stack/pos0`` leaf the encoder's blocks."""
    nf, period, reps, nt = params.layout

    def block(prefix, layers, blocks=params.blocks, name="blocks"):
        return [(prefix + path, [f"{name}.{i}.{'.'.join(path)}" for i in layers])
                for path in _leaf_paths(blocks[layers[0]])]

    out = [(("embed",), ["embed"])]
    enc = params.encoder
    if enc is not None:  # "encoder" sorts between "embed" and "final_norm"
        out.append((("encoder", "final_norm", "scale"), ["encoder.final_norm.scale"]))
        out += block(("encoder", "stack", "pos0"), list(range(len(enc.blocks))), enc.blocks,
                     "encoder.blocks")
    out.append((("final_norm", "scale"), ["final_norm.scale"]))
    for i in range(nf):
        out += block(("first", str(i)), [i])
    if params.lm_head is not None:
        out.append((("lm_head",), ["lm_head"]))
    for pos in sorted(range(period), key=lambda i: f"pos{i}"):
        out += block(("stack", f"pos{pos}"), [nf + r * period + pos for r in range(reps)])
    for i in range(nt):
        out += block(("tail", str(i)), [nf + reps * period + i])
    return out


def _leaf_paths(tree) -> list[tuple[str, ...]]:
    """The key paths of a block's nested dicts of tensors, keys sorted at
    every level (``jax.tree_util``'s dict order)."""
    paths = []
    for k in sorted(tree):
        v = tree[k]
        paths += [(k,) + p for p in _leaf_paths(v)] if isinstance(v, nn.Module) else [(k,)]
    return paths


def reference_tree(params: LM, tensors: dict) -> dict:
    """Tensors keyed by ``params``' parameter names (the parameters, their
    gradients, AdamW's moments) -> the reference's stacked pytree of numpy
    arrays, as ``init_params`` there lays it out."""
    nf, _, _, nt = params.layout
    tree: dict = {}
    for path, names in reference_leaves(params):
        arrays = [tensors[n].detach().cpu().numpy() for n in names]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrays) if "stack" in path[:2] else arrays[0]
    for part, n in (("first", nf), ("tail", nt)):
        tree[part] = tuple(tree.get(part, {})[str(i)] for i in range(n))
    return tree


def flat_runs(params: LM) -> list[tuple[str, int]]:
    """(parameter name, offset) of each of an LM's tensors in its flat vector."""
    named = dict(params.named_parameters())
    runs, off = [], 0
    for _, names in reference_leaves(params):
        for n in names:
            runs.append((n, off))
            off += named[n].numel()
    return runs


def flatten_lm(params: LM) -> torch.Tensor:
    """An LM -> one vector in the reference's ``tree_leaves`` order of its
    stacked tree (its ``flatten_params``), each stacked leaf raveled
    layer-major, copied tensor by tensor on the parameters' device."""
    named = dict(params.named_parameters())
    out = params.embed.new_empty(sum(p.numel() for p in named.values()))
    with torch.no_grad():
        for n, off in flat_runs(params):
            p = named[n]
            out[off:off + p.numel()].view(p.shape).copy_(p)
    return out


def lm_views(flat: torch.Tensor, like: LM) -> LM:
    """The inverse of :func:`flatten_lm`: an LM shaped as ``like`` whose
    parameters are views into ``flat`` (no copy; writing them writes it)."""
    named = dict(like.named_parameters())
    views = {n: flat[off:off + named[n].numel()].view(named[n].shape)
             for n, off in flat_runs(like)}
    blocks = [blk.as_module(_view_tree(block, f"blocks.{i}", views))
              for i, block in enumerate(like.blocks)]
    encoder = None
    if like.encoder is not None:
        encoder = Encoder(views["encoder.final_norm.scale"],
                          [blk.as_module(_view_tree(block, f"encoder.blocks.{i}", views))
                           for i, block in enumerate(like.encoder.blocks)])
    return LM(views["embed"], views["final_norm.scale"], blocks, views.get("lm_head"),
              layout=like.layout, encoder=encoder)


def _view_tree(mod, prefix: str, views: dict) -> dict:
    """A block's nested dict of the views named ``prefix.key...``. A module
    function, not a recursive closure: a closure that calls itself is a
    reference cycle, which would keep ``views``, and so the whole flat
    vector (a federated round's (m, d) client stack), alive until the
    garbage collector runs."""
    return {k: _view_tree(v, f"{prefix}.{k}", views) if isinstance(v, nn.Module)
            else views[f"{prefix}.{k}"] for k, v in mod.items()}


def params_to_numpy(cfg: ModelConfig, params: LM) -> dict:
    """An :class:`LM` -> the reference's parameter pytree, as numpy arrays
    (the inverse of :func:`params_from_numpy`)."""
    if params.layout != stack_layout(cfg):
        raise ValueError(f"params laid out {params.layout}, {cfg.name} is {stack_layout(cfg)}")
    return reference_tree(params, dict(params.named_parameters()))


def param_count(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


def make_angles(cfg: ModelConfig, positions: torch.Tensor) -> Optional[torch.Tensor]:
    """positions (S,) -> rope angles (S, rotated dims // 2): the head dim,
    or MLA's ``rope_head_dim`` (MLA rotates only its rope part); None for an
    encoder-decoder (whisper adds sinusoidal positions instead) and for a
    model with no attn, local or mla mixer (xLSTM), as the reference's.
    With ``cfg.mrope`` the text stream t = h = w goes through M-RoPE."""
    if cfg.encoder is not None:
        return None
    if not any(m in ("attn", "local", "mla") for m, _ in cfg.all_blocks):
        return None
    hd = cfg.mla.rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    if cfg.mrope:
        return mrope_angles(torch.stack([positions] * 3), hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_angles(positions, hd, cfg.rope_theta)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal position encodings, f32: positions (...,) ->
    (..., d), the sines of the ``d // 2`` frequencies, then their cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=positions.device) / (half - 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(cfg: ModelConfig, params: LM, frames: torch.Tensor) -> torch.Tensor:
    """frames: the stubbed conv front end's output (B, F, D) -> encoder
    states, in ``cfg.dtype``. Each block runs under ``torch.utils.checkpoint``
    with ``cfg.remat`` and gradients on, as the reference's scan body under
    ``jax.checkpoint``."""
    x = frames.to(getattr(torch, cfg.dtype))
    x = x + sinusoidal(torch.arange(x.shape[1], device=x.device), cfg.d_model).to(x.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for block in params.encoder.blocks:
        if remat:
            x, _ = checkpoint(_block_train, cfg, blk.ENCODER, block, x, None, None,
                              use_reentrant=False)
        else:
            x = blk.block_apply(cfg, blk.ENCODER, block, x, angles=None, mode="full")[0]
    return rmsnorm(params.encoder.final_norm, x, cfg.norm_eps)


def _embed(cfg: ModelConfig, params: LM, tokens: torch.Tensor) -> torch.Tensor:
    # the gather commutes with the cast: take(embed.astype(dt)) in the reference
    return F.embedding(tokens, params.embed).to(getattr(torch, cfg.dtype))


def forward(
    cfg: ModelConfig,
    params: LM,
    tokens: torch.Tensor,  # (B, S) int
    *,
    vision_embeds: Optional[torch.Tensor] = None,  # (B, P, D) VLM stub
    frames: Optional[torch.Tensor] = None,  # (B, F, D) audio stub
    caches: Optional[Cache] = None,
    decode_window: int = 0,
) -> tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (hidden (B,S,D), caches', aux_loss). ``vision_embeds``
    replace the first P token slots; with an encoder, ``frames`` go through
    :func:`encode` and the decoder adds sinusoidal positions."""
    s = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    if vision_embeds is not None:
        p = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, p:]], dim=1)
    enc_out = None
    if cfg.encoder is not None:
        enc_out = encode(cfg, params, frames)
        x = x + sinusoidal(torch.arange(s, device=x.device), cfg.d_model).to(x.dtype)
    angles = make_angles(cfg, torch.arange(s, device=tokens.device))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    new_layers = []
    for i, (kind, block) in enumerate(zip(cfg.all_blocks, params.blocks)):
        c = caches["layers"][i] if caches is not None else None
        if remat:
            x, a = checkpoint(_block_train, cfg, kind, block, x, angles, enc_out,
                              use_reentrant=False)
            nc = None
        else:
            x, nc, a = blk.block_apply(cfg, kind, block, x, angles=angles, mode="full", cache=c,
                                       enc_out=enc_out, decode_window=decode_window)
        if a is not None:
            aux = aux + a
        new_layers.append(nc)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    new_caches = None if caches is None else {"layers": new_layers, "pos": s}
    return x, new_caches, aux


def _block_train(cfg: ModelConfig, kind, block, x: torch.Tensor, angles: Optional[torch.Tensor],
                 enc_out: Optional[torch.Tensor]):
    x, _, aux = blk.block_apply(cfg, kind, block, x, angles=angles, mode="full", enc_out=enc_out)
    return x, aux


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
    input_embed: Optional[torch.Tensor] = None,  # (B, 1, D) overrides the token
) -> tuple[torch.Tensor, Cache]:
    """One-token serve step. Returns (logits (B, V), caches')."""
    pos = caches["pos"]
    dt = getattr(torch, cfg.dtype)
    x = _embed(cfg, params, token) if input_embed is None else input_embed.to(dt)
    position = torch.tensor([pos], device=x.device)
    if cfg.encoder is not None:
        x = x + sinusoidal(position, cfg.d_model).to(dt)
    angles = make_angles(cfg, position)
    new_layers = []
    for kind, block, c in zip(cfg.all_blocks, params.blocks, caches["layers"]):
        x, nc, _ = blk.block_apply(cfg, kind, block, x, angles=angles, mode="decode", cache=c,
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
    """Zero decode-state for every block: ``{"layers": [...], "pos": 0}``;
    an encoder-decoder's blocks hold cross-attention's ``ck`` / ``cv`` over
    the encoder's ``n_frames``. ``device="meta"`` builds the shapes only."""
    check_ported(cfg)
    dev = resolve_or_meta(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    cross_len = cfg.encoder.n_frames if cfg.encoder is not None else 0
    return {
        "layers": [blk.init_block_cache(cfg, kind, batch, cache_len, dtype, dev,
                                        decode_window=decode_window, cross_len=cross_len)
                   for kind in cfg.all_blocks],
        "pos": 0,
    }


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def loss_fn(
    cfg: ModelConfig,
    params: LM,
    tokens: torch.Tensor,  # (B, S) int
    targets: torch.Tensor,  # (B, S) int
    *,
    vision_embeds: Optional[torch.Tensor] = None,
    frames: Optional[torch.Tensor] = None,
    aux_weight: float = 0.01,
) -> tuple[torch.Tensor, dict]:
    """Next-token CE (f32), plus ``aux_weight`` × the MoE aux loss (zero
    without an MoE block)."""
    hidden, _, aux = forward(cfg, params, tokens, vision_embeds=vision_embeds, frames=frames)
    if cfg.fused_ce:
        ce = _chunked_ce(cfg, params, hidden, targets)
    else:
        logits = logits_from_hidden(cfg, params, hidden).to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, -1, targets[..., None].long()).mean()
    total = ce + aux_weight * aux
    return total, {"ce": ce, "aux": aux}


def _chunk_ce_sum(head: torch.Tensor, h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    logits = (h @ head.to(h.dtype)).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, t[..., None].long()).sum()


def _chunked_ce(cfg: ModelConfig, params: LM, hidden: torch.Tensor, targets) -> torch.Tensor:
    """CE over sequence chunks, never the (B, S, V) logits at once.

    The reference's chunk count; each chunk's logits are recomputed in the
    backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint``).
    """
    b, s, _ = hidden.shape
    n_chunks = max(1, min(16, s // 512)) if s >= 512 else 1
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        h, t = hidden[:, i * cs:(i + 1) * cs], targets[:, i * cs:(i + 1) * cs]
        if remat:
            tot = tot + checkpoint(_chunk_ce_sum, head, h, t, use_reentrant=False)
        else:
            tot = tot + _chunk_ce_sum(head, h, t)
    return tot / (b * s)
