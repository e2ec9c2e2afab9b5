"""Clustered-sampling FL over a transformer LM.

Port of ``src/repro/launch/fl_train.py``. Each round the host-side sampler
(MD / Algorithm 1 / Algorithm 2 / any ``SAMPLERS`` scheme) draws m
clients; each runs N local SGD steps on its own token stream from the
round's global model θ; the new global model is Σ_k ω_k θ_k (eq. 4), and
similarity-based samplers receive the flat updates θ_k − θ.

The reference runs the m clients under ``vmap`` inside one jit; the port
runs them one after another, with the same numbers. The m client models
live in one (m, d) f32 stack: client k's parameters are views into row k
(:func:`~repro_torch.models.model.lm_views`), so its local steps
write θ_k straight into the stack and no client model is flattened. The
combine is the aggregate kernel (B2) on that stack, and the updates are
formed in place after it, so a round holds one stack (19.1 GB at
qwen3-0.6b with m = 8), not a second.

With ``mesh=`` (:mod:`repro_torch.launch.mesh`) one process drives every
card: θ has a replica on each data group's card, each client trains on its
group's card (the client axis in ceil blocks, :func:`fl_round_shardings`),
in the same order as without a mesh, as views into that card's block of
the (m, d) stack. B2 runs once a card over its block; the partials are
added on the lead card in group order (one foreign partial resident there
at a time), and the updates stay on their cards, where the store's sketch
(B3) runs on them. A group's work runs as its first mesh position
(``on_shard``); the copies between positions report their bytes to the
dry-run's counter (``_build.count_moved``): θ^t, the clients' batches and
weights sent from the lead as collective-permutes, the losses and the
partial sums to the lead as all-reduces.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.samplers.base import ClientSampler
from repro_torch.device import resolve_device
from repro_torch.fl.aggregation import aggregate_sharded, replicate
from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ops import aggregate_flat
from repro_torch.launch.mesh import (
    Placement,
    ShardedRows,
    blocks,
    check_lead,
    data_group_positions,
    data_parallel_degree,
    group_devices,
    lead_device,
    leading_batch_spec,
    on_shard,
)
from repro_torch.models import model as mdl
from repro_torch.models.config import ModelConfig


def make_local_sgd(cfg: ModelConfig, lr: float, n_local_steps: int):
    """One client's round: N SGD steps on its own token stream, in place."""

    def local_sgd(params: mdl.LM, tokens: torch.Tensor, targets: torch.Tensor):
        """tokens, targets (N, B_local, S): pre-drawn local batches. Updates
        ``params`` in place; returns it and the mean of the N losses."""
        leaves = list(params.parameters())
        losses = []
        for tb, gb in zip(tokens, targets):
            loss, _ = mdl.loss_fn(cfg, params, tb, gb)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for w, g in zip(leaves, grads):
                    w.sub_(lr * g.to(w.dtype))
            losses.append(loss.detach())
        return params, torch.stack(losses).mean()

    return local_sgd


def make_fl_round_step(cfg: ModelConfig, lr: float, n_local_steps: int, *, with_updates: bool = False,
                       mesh=None):
    """``with_updates=True`` also returns the (m, d) flat per-client updates
    θ_k^{t+1} − θ^t (Algorithm 2 line 1's input): the client stack itself,
    rewritten in place once the combine has read it — over ``mesh`` a
    :class:`~repro_torch.launch.mesh.ShardedRows` of each card's block."""
    local_sgd = make_local_sgd(cfg, lr, n_local_steps)
    if mesh is not None:
        return _sharded_round_step(local_sgd, mesh, with_updates)

    def fl_round_step(params: mdl.LM, client_tokens, client_targets, weights):
        """params: the global model; client_tokens / targets: (m, N, B, S);
        weights: (m,) f32 realized aggregation weights, on params' device."""
        theta = mdl.flatten_lm(params)
        stack = theta.new_empty((client_tokens.shape[0], theta.numel()))
        losses = []
        for k in range(stack.shape[0]):
            stack[k].copy_(theta)
            client = mdl.lm_views(stack[k], params).requires_grad_(True)
            _, loss = local_sgd(client, client_tokens[k], client_targets[k])
            losses.append(loss)
        # θ^{t+1} = Σ_k ω_k θ_k — eq. (4), the aggregate kernel
        new_params = mdl.lm_views(aggregate_flat(stack, weights), params)
        loss = torch.stack(losses).mean()
        if not with_updates:
            return new_params, loss
        return new_params, loss, stack.sub_(theta)

    return fl_round_step


def _sharded_round_step(local_sgd, mesh, with_updates: bool):
    """:func:`make_fl_round_step`'s round over ``mesh``'s data groups."""
    lead = lead_device(mesh)
    devs = group_devices(mesh)
    firsts = [row[0] for row in data_group_positions(mesh)]

    def fl_round_step(params: mdl.LM, client_tokens, client_targets, weights):
        theta = mdl.flatten_lm(params)
        d = theta.numel()
        thetas = replicate(theta, mesh)  # θ^t on every group's device
        spans = blocks(client_tokens.shape[0], len(devs))
        stacks, losses = [], []
        for (a, b), dev, pos, th in zip(spans, devs, firsts, thetas):
            with on_shard(pos, dev):
                stack = th.new_empty((b - a, d))
                for k in range(a, b):
                    stack[k - a].copy_(th)
                    client = mdl.lm_views(stack[k - a], params).requires_grad_(True)
                    for t in (client_tokens[k], client_targets[k]):
                        _build.count_moved("collective-permute", 0, pos, t.numel() * t.element_size())
                    _, loss = local_sgd(client, client_tokens[k].to(dev), client_targets[k].to(dev))
                    _build.count_moved("all-reduce", pos, 0, loss.element_size())
                    losses.append(loss.to(lead))
            stacks.append(stack)
        for (a, b), pos in zip(spans, firsts):
            _build.count_moved("collective-permute", 0, pos, 4 * (b - a))
        shards = ((pos, st, weights[a:b].to(st.device))
                  for pos, st, (a, b) in zip(firsts, stacks, spans) if b > a)
        # θ^{t+1} = Σ_k ω_k θ_k — eq. (4), the aggregate kernel once a card
        new_params = mdl.lm_views(aggregate_sharded(shards, lead), params)
        loss = torch.stack(losses).mean()
        if not with_updates:
            return new_params, loss
        updates = [st.sub_(th) for st, th in zip(stacks, thetas)]
        return new_params, loss, ShardedRows(updates, d)

    return fl_round_step


def fl_input_specs(cfg: ModelConfig, m: int, n_local: int, batch: int, seq: int):
    """The round step's batch as meta tensors: the reference's shapes, in
    the dtypes the port's round step takes."""
    del cfg

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "client_tokens": meta((m, n_local, batch, seq), torch.int64),
        "client_targets": meta((m, n_local, batch, seq), torch.int64),
        "weights": meta((m,), torch.float32),
    }


def fl_round_shardings(mesh):
    """The round step's batch placements
    (:class:`~repro_torch.launch.mesh.Placement`): the client axis on the
    mesh's batch axes (each data group plays its block of the sampled
    clients), the weights replicated."""
    return {
        "client_tokens": Placement(mesh, leading_batch_spec(mesh, 4)),
        "client_targets": Placement(mesh, leading_batch_spec(mesh, 4)),
        "weights": Placement(mesh, (None,)),
    }


# --------------------------------------------------------------------------
# host-side driver
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FLLMConfig:
    n_clients: int = 32
    m: int = 8
    n_rounds: int = 10
    n_local_steps: int = 4
    local_batch: int = 4
    seq_len: int = 64
    lr: float = 0.05
    # A registry name, a spec dict, or a repro_torch.fl.experiment.SamplerSpec
    # — all three resolve through the shared SamplerSpec path (the spec's
    # m/seed default to this config's when given as a bare name).
    sampler: Any = "algorithm1"
    seed: int = 0
    # Plan-rebuild scheduling for similarity-based samplers: "sync" | "async"
    # mode string, a spec dict, or a PlannerSpec.
    planner: Any = "sync"

    def sampler_spec(self):
        from repro_torch.fl.experiment import SamplerSpec

        s = self.sampler
        if isinstance(s, dict):
            # a dict may omit m/seed — they default to this config's
            s = SamplerSpec.from_dict({"m": self.m, "seed": self.seed, **s})
        if not isinstance(s, SamplerSpec):
            return SamplerSpec(name=s, m=self.m, seed=self.seed)
        if s.m != self.m:
            raise ValueError(
                f"SamplerSpec.m={s.m} contradicts FLLMConfig.m={self.m} — the "
                "LM driver sizes every round's client axis by fl.m, so the "
                "sampler must draw exactly that many"
            )
        return s

    def planner_spec(self):
        from repro_torch.fl.experiment import PlannerSpec

        p = self.planner
        if isinstance(p, PlannerSpec):
            return p
        if isinstance(p, dict):
            return PlannerSpec.from_dict(p)
        return PlannerSpec(mode=p)


def make_lm_sampler(fl: FLLMConfig, population, update_dim: int, *, device="cuda") -> ClientSampler:
    """Build ``fl.sampler`` for the LM driver via the shared SamplerSpec path.

    ``update_dim`` is the flattened model size — Algorithm 2's gradient
    store holds (n_clients, update_dim) f32 on ``device`` (or (n_clients,
    d′) under a sketch), and its plan service runs under ``fl.planner``.
    """
    from repro_torch.fl.experiment import build_sampler

    return build_sampler(
        fl.sampler_spec(),
        population,
        planner=fl.planner_spec(),
        update_dim=update_dim or None,
        device=device,
    )


def run_federated_lm(
    cfg: ModelConfig, fl: FLLMConfig, sampler: ClientSampler, *, mesh=None, device="cuda"
) -> list[float]:
    """Federated LM training over synthetic per-client token streams.

    Each client owns a token stream with a client-specific structure (its
    ``TokenPipeline`` seed), heterogeneous in the paper's non-iid sense.
    Returns the per-round mean local loss. Initial parameters come from
    ``init_params(cfg, fl.seed)`` on ``device``.

    The round's clients train in an order that puts the distinct clients
    first, by id, and a client drawn twice after them; its first draw's
    update is the one observed, as in the reference. Their batches are drawn
    in the sampler's order, as in the reference.

    With ``mesh`` (lead device ``device``) each data group trains its block
    of the round's clients on its own card (see the module docstring); the
    data-parallel degree must divide ``fl.m``.
    """
    from repro_torch.data.tokens import TokenPipeline

    dev = resolve_device(device)
    if mesh is not None:
        check_lead(mesh, dev, "run_federated_lm")
        n_dp = data_parallel_degree(mesh)
        if fl.m % n_dp != 0:
            raise ValueError(
                f"fl.m={fl.m} must be a multiple of the mesh's data-parallel "
                f"degree {n_dp} — the jit shards the client axis over it, so "
                "each data group must play a whole number of clients"
            )
    pipes = [
        TokenPipeline(cfg.vocab_size, fl.local_batch, fl.seq_len, seed=1000 + 17 * c)
        for c in range(fl.n_clients)
    ]
    params = mdl.init_params(cfg, fl.seed, device=dev)
    # similarity-based samplers need the per-client representative gradients
    # back: the round step then also returns the (m, d) flat updates
    feedback = getattr(sampler, "consumes_updates", False)
    round_step = make_fl_round_step(cfg, fl.lr, fl.n_local_steps, with_updates=feedback, mesh=mesh)
    losses = []
    for t in range(fl.n_rounds):
        res = sampler.sample(t)
        clients = np.asarray(res.clients)
        toks = np.stack(
            [
                np.stack([pipes[int(c)].next_batch().tokens for _ in range(fl.n_local_steps)])
                for c in clients
            ]
        )
        tgts = (toks * 1 + 31) % cfg.vocab_size  # same structure as TokenPipeline
        weights = np.full(len(clients), 1.0 / len(clients), np.float32)
        # distinct clients first, by id (np.unique's first occurrences), then
        # the repeated draws: the observed updates are the stack's leading rows
        ids, first = np.unique(clients, return_index=True)
        order = np.concatenate([first, np.setdiff1d(np.arange(len(clients)), first)])
        out = round_step(
            params,
            torch.from_numpy(toks[order]).to(dev, torch.int64),
            torch.from_numpy(tgts[order]).to(dev, torch.int64),
            torch.from_numpy(weights[order]).to(dev),
        )
        if feedback:
            params, loss, updates = out
            sampler.observe_updates(ids.astype(np.int64), updates[: len(ids)])
            del updates  # the round's stack, freed before the next round makes one
        else:
            params, loss = out
        del out
        losses.append(float(loss))
    return losses
