"""Step functions of the LM tier: train, prefill and serve.

Port of ``src/repro/launch/steps.py``. PyTorch runs eagerly, so a step is a
plain function; nothing is jitted. The train step updates the LM's
parameters in place (the reference returns new arrays): at qwen3-0.6b that
saves a second 2.38 GB copy of them. ``launch/serve.py``'s ``generate``
runs the prefill and serve steps. A batch may carry the front ends'
stubbed outputs, ``vision_embeds`` and ``frames``, beside its tokens
(:func:`frontend_stubs` makes the zero stubs the reference's CLIs feed).
The reference's ``input_specs``, ``abstract_params``,
``abstract_train_state`` and the ``fl_engine_*`` lowering hooks place a
train step over a mesh (FSDP / tensor parallel) for XLA; here they raise,
naming ROADMAP A13.2.
"""
from __future__ import annotations

from typing import Optional

import torch

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
def make_train_step(cfg: ModelConfig, opt: Optimizer, *, clip_norm: float = 1.0):
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
# placements over a mesh: not ported (ROADMAP A13.2)
# --------------------------------------------------------------------------
def _a13_2(name: str):
    def raises(*args, **kwargs):
        del args, kwargs
        raise NotImplementedError(
            f"{name} places a train step over a mesh (FSDP / tensor parallel), "
            "not ported (ROADMAP A13.2)"
        )

    raises.__name__ = name
    return raises


input_specs = _a13_2("input_specs")
abstract_params = _a13_2("abstract_params")
abstract_train_state = _a13_2("abstract_train_state")
fl_engine_input_specs = _a13_2("fl_engine_input_specs")
fl_engine_shardings = _a13_2("fl_engine_shardings")
make_fl_engine_step = _a13_2("make_fl_engine_step")
