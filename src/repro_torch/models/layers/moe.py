"""Mixture-of-Experts FFN with GShard-style capacity dispatch.

Port of ``src/repro/models/layers/moe.py`` (qwen2-moe: 4 shared + 60
routed, top-4). Tokens are processed in fixed-size groups, and a token's
place in its expert's queue is its rank among the group's tokens routed
there; tokens at a place ≥ the capacity ``c`` are dropped (GShard
semantics). The reference dispatches through one-hot (s, e, c) einsums,
the TPU's formulation. The port computes the same function in PyTorch's
idiom: the kept tokens are gathered into an (e, slots, d) buffer (each slot
holds one token or zeros, so the gather equals the dispatch einsum bit for
bit), ``torch.bmm`` runs gate, up and down over the experts, and each
token sums its experts' outputs weighted by its gates. The buffer holds
min(c, group size) slots a group: no queue place reaches the group size.

Routing decisions follow the reference exactly: router logits in the
compute dtype, then f32 for the softmax; ties among equal probabilities go
to the lower expert index (``jax.lax.top_k``'s rule; a stable descending
sort keeps it); gates renormalised by their sum + 1e-9; queue places from
the cumulative count over the group's tokens in order; gates cast to the
compute dtype before the combine. The auxiliary load-balance loss follows
Switch/GShard: ``n_e · Σ_e f_e · P_e``, the mean over groups.

Under a gradient the gather's backward sums each token's slots back into
its row and the combine's carries each choice's gate, so autograd gives
the reference's gradient: through the kept gates and the experts, and
through the router's softmax both to the gates and to the aux loss's
P_e (f_e, the choices and the places carry none). A recompute under
``torch.utils.checkpoint`` routes the same tokens the same way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.mlp import init_mlp, mlp


def expert_capacity(moe) -> int:
    cap = int(moe.group_size * moe.top_k / moe.n_routed * moe.capacity_factor)
    return max(cap, moe.top_k)


def init_moe(cfg: ModelConfig, gen: Optional[torch.Generator], device) -> dict:
    """Router, the stacked routed experts (E, d, d_ff) / (E, d_ff, d) and the
    shared experts' MLP (d_ff_expert × n_shared wide), in the reference's
    scales."""
    moe = cfg.moe
    d, e, f = cfg.d_model, moe.n_routed, moe.d_ff_expert

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    p = {
        "router": normal((d, e), d**-0.5),
        "e_gate": normal((e, d, f), d**-0.5),
        "e_up": normal((e, d, f), d**-0.5),
        "e_down": normal((e, f, d), f**-0.5),
    }
    if moe.n_shared:
        p["shared"] = init_mlp(d, f * moe.n_shared, gen, device)
    return p


class Routing(NamedTuple):
    """One batch of groups' routing: each (group, token, choice) names an
    expert, its gate and its place in that expert's queue."""

    probs: torch.Tensor  # (G, gs, e) f32 router softmax
    gate: torch.Tensor  # (G, gs, k) f32, renormalised over the k choices
    expert: torch.Tensor  # (G, gs, k) int64, in descending probability
    place: torch.Tensor  # (G, gs, k) int64, the token's rank in the expert's queue
    kept: torch.Tensor  # (G, gs, k) bool, place < capacity
    tokens_per_expert: torch.Tensor  # (G, e) f32, f_e: the share of tokens routed to e


def token_groups(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (G, gs, D) groups of gs = min(group_size, B·S) tokens,
    the tail group padded with zero tokens."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    gs = min(cfg.moe.group_size, b * s)
    rem = (b * s) % gs
    if rem:  # pad tokens route but take the queues' last places
        flat = torch.cat([flat, flat.new_zeros((gs - rem, d))])
    return flat.view(-1, gs, d)


def route(cfg: ModelConfig, params, groups: torch.Tensor) -> Routing:
    """The router's choices for (G, gs, D) groups in the compute dtype."""
    moe = cfg.moe
    k = moe.top_k
    logits = (groups @ params["router"].to(groups.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first among equal values
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :k], order[..., :k]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    routed = torch.zeros(probs.shape, dtype=torch.int64, device=probs.device).scatter_(-1, expert, 1)
    place = (torch.cumsum(routed, dim=1) - 1).gather(-1, expert)
    return Routing(probs, gate, expert, place, place < expert_capacity(moe),
                   routed.to(torch.float32).mean(dim=1))


def _experts(params, xe: torch.Tensor) -> torch.Tensor:
    """(e, rows, d) -> (e, rows, d): each expert's gated MLP on its rows."""
    dt = xe.dtype
    h = F.silu(torch.bmm(xe, params["e_gate"].to(dt))) * torch.bmm(xe, params["e_up"].to(dt))
    return torch.bmm(h, params["e_down"].to(dt))


def moe_ffn(cfg: ModelConfig, params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out, aux_loss)."""
    moe = cfg.moe
    b, s, d = x.shape
    groups = token_groups(cfg, x)
    n_groups, gs, _ = groups.shape
    e = moe.n_routed
    slots = min(expert_capacity(moe), gs)
    r = route(cfg, params, groups)

    # dispatch: slot (expert, group, place) of the buffer <- its token; a
    # choice over capacity points at the spare slot past the end
    group = torch.arange(n_groups, device=x.device).view(-1, 1, 1)
    slot = torch.where(r.kept, (r.expert * n_groups + group) * slots + r.place, e * n_groups * slots)
    token = (group * gs + torch.arange(gs, device=x.device).view(1, -1, 1)).expand_as(slot)
    zero_row = n_groups * gs  # the zero row appended below
    token_of_slot = torch.full((e * n_groups * slots + 1,), zero_row, dtype=torch.int64,
                               device=x.device).scatter_(0, slot.reshape(-1), token.reshape(-1))
    rows = torch.cat([groups.reshape(-1, d), groups.new_zeros((1, d))])
    xe = rows[token_of_slot[:-1]].view(e, n_groups * slots, d)
    ye = _experts(params, xe).view(-1, d)

    # combine: each token's k expert outputs weighted by its gates (zero
    # for a dropped choice), the gates in the compute dtype
    w = (r.gate * r.kept).to(x.dtype)
    picked = ye[slot.clamp(max=ye.shape[0] - 1)]  # (G, gs, k, d)
    out = (w.float()[..., None] * picked.float()).sum(dim=2).to(x.dtype)
    out = out.reshape(-1, d)[: b * s].reshape(b, s, d)

    aux = (e * (r.tokens_per_expert * r.probs.mean(dim=1)).sum(-1)).mean()
    if moe.n_shared:
        out = out + mlp(cfg, params["shared"], x)
    return out, aux
