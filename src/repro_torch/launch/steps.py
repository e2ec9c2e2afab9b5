"""Step functions of the LM tier: train, prefill and serve, and their
inputs and placements over a mesh.

Port of ``src/repro/launch/steps.py``. PyTorch runs eagerly, so a step is a
plain function; nothing is jitted. The train step updates the LM's
parameters in place (the reference returns new arrays): at qwen3-0.6b that
saves a second 2.38 GB copy of them. ``launch/serve.py``'s ``generate``
runs the prefill and serve steps. A batch may carry the front ends'
stubbed outputs, ``vision_embeds`` and ``frames``, beside its tokens
(:func:`frontend_stubs` makes the zero stubs the reference's CLIs feed).

:func:`input_specs`, :func:`abstract_params` and :func:`abstract_train_state`
are the reference's shape stand-ins as meta tensors;
``launch/dryrun.py``'s ``build_shardings`` places them
(``launch/sharding.py``). The reference compiles a train step under those
placements (``jax.jit(step, in_shardings=…, out_shardings=…)``); eager
PyTorch cannot lower a program without running it, so
``make_train_step(..., mesh=)`` is a step that runs under them: the state
stays in its placements (FSDP storage) and each data group gathers the
whole model onto its first device to compute (see
:func:`_sharded_train_step`). The ``fl_engine_*`` hooks wrap
``fl/engine.py``'s round as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.fl.engine import FEATURE_DTYPE, INDEX_DTYPE, batched_round_step
from repro_torch.kernels import _build
from repro_torch.launch.mesh import (
    Mesh,
    Placement,
    data_group_positions,
    data_parallel_degree,
    lead_device,
    leading_batch_spec,
    on_shard,
)
from repro_torch.launch.sharding import Placed, leaves, place_tensor
from repro_torch.models import model as mdl
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim import adamw, clip_by_global_norm
from repro_torch.optim.base import Optimizer


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------
def decode_window_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Sliding-window decode applies to 'attn' blocks in long_500k only."""
    has_full_attn = any(m == "attn" for m, _ in cfg.all_blocks)
    if shape.name == "long_500k" and has_full_attn and cfg.mla is None:
        return cfg.sliding_window
    return 0


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    window = decode_window_for(cfg, shape)
    return min(shape.seq_len, window) if window else shape.seq_len


def frontend_stubs(cfg: ModelConfig, batch: int, device) -> dict:
    """The zero front-end stubs of ``cfg``, as the reference's serve and
    train CLIs make them: ``vision_embeds`` (B, n_vision_tokens, d_model)
    for a VLM, ``frames`` (B, n_frames, d_model) for an audio model, in
    ``cfg.dtype``; empty for a text model."""
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision":
        return {"vision_embeds": torch.zeros((batch, cfg.n_vision_tokens, cfg.d_model), dtype=dt,
                                             device=device)}
    if cfg.frontend == "audio":
        return {"frames": torch.zeros((batch, cfg.encoder.n_frames, cfg.d_model), dtype=dt,
                                      device=device)}
    return {}


def default_optimizer() -> Optimizer:
    return adamw(3e-4, weight_decay=0.1)


def init_train_state(params: mdl.LM, opt: Optimizer) -> dict:
    """``{"params", "opt_state", "step"}`` for :func:`make_train_step`; turns
    on ``requires_grad`` of ``params``. The optimizer's trees are dicts keyed
    by the LM's parameter names."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    return {"params": params, "opt_state": opt.init(named),
            "step": torch.zeros((), dtype=torch.int32, device=params.embed.device)}


def train_state_tree(state: dict) -> dict:
    """The train state as the reference's pytree of numpy arrays (params and
    AdamW's ``mu`` / ``nu`` stacked as the reference's ``init_params`` lays
    them out), for ``repro_torch.checkpoint.save_checkpoint``: a bundle the
    reference's ``restore_checkpoint`` reads."""
    params = state["params"]
    opt = state["opt_state"]
    return {
        "params": mdl.reference_tree(params, dict(params.named_parameters())),
        "opt_state": {"mu": mdl.reference_tree(params, opt["mu"]),
                      "nu": mdl.reference_tree(params, opt["nu"]),
                      "count": opt["count"].cpu().numpy()},
        "step": state["step"].cpu().numpy(),
    }


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------
def make_train_step(cfg: ModelConfig, opt: Optimizer, *, clip_norm: float = 1.0,
                    mesh: Optional[Mesh] = None):
    """The train step on one device, or with ``mesh`` over its positions:
    then the state is placed by ``launch/dryrun.py``'s ``build_shardings``
    (``launch.sharding.place``) and the batch by ``batch_shardings``, and
    the step returns the state under the same placements and the metrics
    on the mesh's lead device (:func:`_sharded_train_step`)."""
    if mesh is not None:
        return _sharded_train_step(cfg, opt, clip_norm, mesh)

    def train_step(state, batch):
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        loss, metrics = mdl.loss_fn(cfg, params, batch["tokens"], batch["targets"],
                                    vision_embeds=batch.get("vision_embeds"),
                                    frames=batch.get("frames"))
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        named = dict(zip(names, leaves))
        updates, opt_state = opt.update(grads, state["opt_state"], named, state["step"])
        with torch.no_grad():
            for n, p in named.items():
                p.add_(updates[n].to(p.dtype))
        new_state = {"params": params, "opt_state": opt_state, "step": state["step"] + 1}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, {"loss": loss.detach(), "grad_norm": gnorm, **metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: InputShape):
    b = shape.global_batch
    cl = shape.seq_len

    @torch.inference_mode()
    def prefill_step(params, batch):
        caches = mdl.init_cache(cfg, b, cl, device=batch["tokens"].device)
        hidden, caches, _ = forward_with_extras(cfg, params, batch, caches)
        logits = mdl.logits_from_hidden(cfg, params, hidden[:, -1:, :])[:, 0]
        return logits, caches

    return prefill_step


def forward_with_extras(cfg: ModelConfig, params: mdl.LM, batch: dict, caches):
    return mdl.forward(cfg, params, batch["tokens"], vision_embeds=batch.get("vision_embeds"),
                       frames=batch.get("frames"), caches=caches)


def make_serve_step(cfg: ModelConfig, shape: InputShape):
    dw = decode_window_for(cfg, shape)

    @torch.inference_mode()
    def serve_step(params, batch):
        return mdl.decode_step(cfg, params, batch["token"], batch["caches"], decode_window=dw)

    return serve_step


def make_step(cfg: ModelConfig, shape: InputShape, opt: Optional[Optimizer] = None):
    """(step_fn, kind) for an (arch, shape) pair."""
    if shape.kind == "train":
        return make_train_step(cfg, opt or default_optimizer()), "train"
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape), "prefill"
    return make_serve_step(cfg, shape), "decode"


# --------------------------------------------------------------------------
# abstract inputs and state
# --------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The step's inputs as meta tensors (no memory), in the reference's
    shapes and dtypes: int32 tokens, the decode caches of
    :func:`~repro_torch.models.model.init_cache`, and the front ends'
    stubs."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp):
        return torch.empty(shp, dtype=torch.int32, device="meta")

    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"], specs["targets"] = meta((b, s)), meta((b, s))
    elif shape.kind == "prefill":
        specs["tokens"] = meta((b, s))
    else:  # decode
        specs["token"] = meta((b, 1))
        specs["caches"] = mdl.init_cache(cfg, b, cache_len_for(cfg, shape),
                                         decode_window=decode_window_for(cfg, shape),
                                         device="meta")
    if shape.kind != "decode":
        specs.update(frontend_stubs(cfg, b, "meta"))
    return specs


def abstract_params(cfg: ModelConfig) -> mdl.LM:
    return mdl.init_params(cfg, device="meta")


def abstract_train_state(cfg: ModelConfig, opt: Optimizer) -> dict:
    return init_train_state(abstract_params(cfg), opt)


# --------------------------------------------------------------------------
# the train step over a mesh
# --------------------------------------------------------------------------
def data_degree(cfg: ModelConfig, mesh: Mesh, batch: int, seq: int) -> int:
    """The data groups a sharded train step runs as: the largest divisor
    of the mesh's data degree that divides ``batch`` and, for a model with
    an MoE block, leaves each block of rows whole token groups. The
    reference's ``moe_ffn`` routes, and computes capacity and ``aux``, over
    groups of ``min(group_size, batch · seq)`` tokens of the global batch;
    data groups whose blocks share a token group run as one."""
    n = data_parallel_degree(mesh)
    gs = 1
    if cfg.moe is not None and any(ffn == "moe" for _, ffn in cfg.all_blocks):
        gs = min(cfg.moe.group_size, batch * seq)
    return max(d for d in range(1, n + 1)
               if n % d == 0 and batch % d == 0 and (batch // d * seq) % gs == 0)


def _local(tree, names: set, keys: list, first: int):
    """A device's share of a placed optimizer state: a dict of parameter
    names as ``{(name, position): block}`` over ``keys``, any other placed
    leaf as its block at position ``first``."""
    if isinstance(tree, Placed):
        return tree.blocks[first]
    if isinstance(tree, dict) and tree and set(tree) == names:
        return {(n, p): tree[n].blocks[p] for n, p in keys}
    if isinstance(tree, dict):
        return {k: _local(v, names, keys, first) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_local(v, names, keys, first) for v in tree)
    return tree


def _merge(tree, names: set, shares: list):
    """The placed optimizer state after each device's update: ``shares``
    holds, for each device, its positions, its keys and its new
    :func:`_local` state."""
    if isinstance(tree, Placed):
        blocks = list(tree.blocks)
        for positions, _, new in shares:
            for p in positions:
                blocks[p] = new
        return Placed(tree.placement, tree.shape, tree.dtype, blocks)
    if isinstance(tree, dict) and tree and set(tree) == names:
        with torch.no_grad():
            for _, keys, new in shares:
                for n, p in keys:
                    if new[(n, p)] is not tree[n].blocks[p]:
                        tree[n].blocks[p].copy_(new[(n, p)])
        return tree
    if isinstance(tree, dict):
        return {k: _merge(v, names, [(ps, ks, new[k]) for ps, ks, new in shares])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_merge(v, names, [(ps, ks, new[i]) for ps, ks, new in shares])
                          for i, v in enumerate(tree))
    return tree


def _check_placed(mesh: Mesh, params: dict, opt_state) -> None:
    """Raise unless every placed leaf is on ``mesh`` and every per-parameter
    optimizer leaf is placed as its parameter."""
    for leaf in leaves(params) + leaves(opt_state):
        if leaf.mesh is not mesh:
            raise ValueError("the train state is placed on another mesh than the step's")
    stack = [opt_state]
    while stack:
        tree = stack.pop()
        if isinstance(tree, dict) and tree and set(tree) == set(params):
            for n, leaf in tree.items():
                if leaf.placement.spec != params[n].placement.spec:
                    raise ValueError(f"optimizer leaf {n} is placed {leaf.placement.spec}, its "
                                     f"parameter {params[n].placement.spec}")
        elif isinstance(tree, dict):
            stack.extend(tree.values())
        elif isinstance(tree, (list, tuple)):
            stack.extend(tree)


def _sharded_train_step(cfg: ModelConfig, opt: Optimizer, clip_norm: float, mesh: Mesh):
    """The one-card step's function on the global batch, up to summation
    order, over ``mesh``'s placed state: each of the :func:`data_degree`
    groups, in group order, gathers the parameters onto its first device
    and runs ``loss_fn`` on its block of rows, its loss weighted by its
    share of the tokens (the loss is the token mean over the global
    batch); each block's gradients are added in group order where the
    block lives; the clip's global norm counts each element once; each
    device runs ``opt.update`` once on every block it stores, so replicated
    blocks stay equal. Compute does not split over "model" (ROADMAP lever
    L8). Launches are tallied under each group's first mesh position."""
    like = abstract_params(cfg)
    named = dict(like.named_parameters())
    runs = [(n, off, named[n].shape, named[n].numel()) for n, off in mdl.flat_runs(like)]
    total = sum(p.numel() for p in named.values())
    firsts = [g[0] for g in data_group_positions(mesh)]
    by_device: dict = {}
    for pos in range(mesh.devices.size):
        by_device.setdefault(mesh.device_key(pos), []).append(pos)
    lead = lead_device(mesh)
    told: set = set()

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt_state"]
        _check_placed(mesh, params, opt_state)
        b, s = batch["tokens"].shape
        d = data_degree(cfg, mesh, b, s)
        if (b, s) not in told:
            told.add((b, s))
            print(f"train_step: batch {b} × {s} over {d} of the mesh's {len(firsts)} data groups")
        grads: dict = {}
        sums: dict = {}
        for k in range(d):
            # data groups k·n/d … (k+1)·n/d − 1 run as one, on the first's device
            pos = firsts[k * len(firsts) // d]
            dev = mesh.devices.flat[pos]
            lo, hi = k * b // d, (k + 1) * b // d
            w = (hi - lo) / b
            with on_shard(pos, dev):
                flat = torch.empty(total, dtype=params["embed"].dtype, device=dev)
                for n, off, shape, numel in runs:
                    params[n].gather(dev, out=flat[off:off + numel].view(shape))
                lm = mdl.lm_views(flat, like)
                lm.requires_grad_(True)
                keys, tensors = zip(*lm.named_parameters())
                rows = {key: v.gather(dev)[lo:hi] for key, v in batch.items()}
                loss, metrics = mdl.loss_fn(cfg, lm, rows["tokens"], rows["targets"],
                                            vision_embeds=rows.get("vision_embeds"),
                                            frames=rows.get("frames"))
                gs = torch.autograd.grad(loss * w, tensors)
            # each block's gradients added in group order where the block lives
            for key, g in zip(keys, gs):
                if k == 0:
                    grads[key] = place_tensor(g, params[key].placement, kind="reduce-scatter")
                else:
                    grads[key].add_(g)
            for key, v in (("loss", loss), ("ce", metrics["ce"]), ("aux", metrics["aux"])):
                _build.count_moved("all-reduce", pos, 0, v.element_size())
                v = v.detach().to(lead) * w
                sums[key] = v if k == 0 else sums[key] + v
            del flat, lm, tensors, gs, loss, metrics
        # the global norm counts every element once, whatever its replicas
        sq = None
        for key in sorted(grads):
            g = grads[key]
            for pos in g.distinct():
                part = g.blocks[pos].to(torch.float32).square().sum()
                _build.count_moved("all-reduce", pos, 0, part.element_size())
                part = part.to(lead)
                sq = part if sq is None else sq + part
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
        for pos in range(mesh.devices.size):
            _build.count_moved("all-reduce", 0, pos, scale.element_size())
        for g in grads.values():
            for pos in g.stored():
                g.blocks[pos].mul_(scale.to(g.blocks[pos].device, g.dtype))
        # each device runs the optimizer once on each block it stores
        names, shares, steps_by_device = set(params), [], {}
        for dev_key, positions in by_device.items():
            seen, keys = set(), []
            for n in named:
                for p in positions:
                    if id(params[n].blocks[p]) not in seen:
                        seen.add(id(params[n].blocks[p]))
                        keys.append((n, p))
            local_params = {(n, p): params[n].blocks[p] for n, p in keys}
            step = state["step"].blocks[positions[0]]
            updates, new = opt.update({(n, p): grads[n].blocks[p] for n, p in keys},
                                      _local(opt_state, names, keys, positions[0]),
                                      local_params, step)
            with torch.no_grad():
                for kk, blk in local_params.items():
                    blk.add_(updates[kk].to(blk.dtype))
            shares.append((positions, keys, new))
            steps_by_device[dev_key] = step + 1
        new_step = Placed(state["step"].placement, (), state["step"].dtype,
                          [steps_by_device[mesh.device_key(p)] for p in range(mesh.devices.size)])
        new_state = {"params": params, "opt_state": _merge(opt_state, names, shares),
                     "step": new_step}
        return new_state, {"loss": sums["loss"], "grad_norm": gnorm, "ce": sums["ce"],
                           "aux": sums["aux"]}

    return train_step


# --------------------------------------------------------------------------
# batched FL round engine (repro_torch.fl.engine): the launch layer's hooks
# --------------------------------------------------------------------------
def fl_engine_input_specs(
    n_clients: int,
    m_slots: int,
    n_pad: int,
    feat_shape: "int | tuple[int, ...]",
    n_steps: int,
    batch_size: int,
) -> dict:
    """One :func:`~repro_torch.fl.engine.batched_round_step`'s inputs as
    meta tensors: the reference's shapes, in the dtypes the engine stages.
    ``feat_shape`` is the per-sample feature shape: an int for flat
    feature vectors, a tuple (e.g. ``(32, 32, 3)``) for image-shaped
    clients."""
    fs = (feat_shape,) if isinstance(feat_shape, int) else tuple(feat_shape)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "x_all": meta((n_clients, n_pad, *fs), FEATURE_DTYPE),
        "y_all": meta((n_clients, n_pad), INDEX_DTYPE),
        "slot_ids": meta((m_slots,), INDEX_DTYPE),
        "batch_idx": meta((m_slots, n_steps, batch_size), INDEX_DTYPE),
        "weights": meta((m_slots,), torch.float32),
        "stale_weight": meta((), torch.float32),
    }


def fl_engine_shardings(mesh: Mesh, specs: dict) -> dict:
    """The placements of :func:`fl_engine_input_specs` on ``mesh``: the
    client and slot axes on the batch axes where the data-parallel degree
    divides them, replicated otherwise; scalars replicated."""
    n_dp = data_parallel_degree(mesh)
    return {key: Placement(mesh, leading_batch_spec(mesh, spec.ndim)
                           if spec.ndim and spec.shape[0] % n_dp == 0 else ())
            for key, spec in specs.items()}


def make_fl_engine_step(loss_fn, opt: Optional[Optimizer] = None, *, fedprox_mu: float = 0.0,
                        mesh: Optional[Mesh] = None):
    """``(params, batch) -> batched_round_step(...)`` over
    :func:`fl_engine_input_specs`' keys; ``mesh`` is the round's, as the
    server runs it."""
    o = opt or default_optimizer()

    def fl_engine_step(params, batch):
        return batched_round_step(
            params, batch["x_all"], batch["y_all"], batch["slot_ids"], batch["batch_idx"],
            batch["weights"], batch["stale_weight"], loss_fn=loss_fn, opt=o,
            fedprox_mu=fedprox_mu, mesh=mesh,
        )

    return fl_engine_step
