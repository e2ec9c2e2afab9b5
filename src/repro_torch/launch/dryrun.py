"""The placements of a step's inputs and outputs over a mesh.

Port of ``build_shardings`` in ``src/repro/launch/dryrun.py``, and of that
function only. The rest of the reference's dry-run (``run_one``,
``_compile``, the cost tables over the 256 / 512-chip TPU pod) lowers and
compiles through XLA, which has no counterpart on one host: ROADMAP
A13.3.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh, Placement
from repro_torch.launch.sharding import (
    batch_shardings,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
    replicated,
)
from repro_torch.launch.steps import abstract_params, abstract_train_state, input_specs
from repro_torch.models import model as mdl
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim.base import Optimizer


def build_shardings(cfg: ModelConfig, shape: InputShape, mesh: Mesh, step_kind: str,
                    opt: Optimizer, *, expert_parallel: bool = False):
    """``(in placements, out placements, (state or params, input specs))``
    of the train, prefill or decode step, as the reference's
    ``build_shardings``: the state, batch and metrics of a train step; the
    parameters, inputs, last logits and caches of a prefill or decode."""
    specs = input_specs(cfg, shape)
    if step_kind == "train":
        state_shape = abstract_train_state(cfg, opt)
        p_sh = param_shardings(mesh, state_shape["params"], expert_parallel=expert_parallel)
        state_sh = {
            "params": p_sh,
            "opt_state": opt_state_shardings(mesh, state_shape["opt_state"], p_sh),
            "step": replicated(mesh, state_shape["step"]),
        }
        metrics_sh = {k: Placement(mesh, ()) for k in ("loss", "grad_norm", "ce", "aux")}
        return (state_sh, batch_shardings(mesh, specs)), (state_sh, metrics_sh), (state_shape, specs)

    params_shape = abstract_params(cfg)
    p_sh = param_shardings(mesh, params_shape, expert_parallel=expert_parallel)
    batch_sh = {k: cache_shardings(mesh, v, cfg) if k == "caches" else batch_shardings(mesh, v)
                for k, v in specs.items()}
    b = shape.global_batch
    logits_sh = batch_shardings(
        mesh, torch.empty((b, cfg.vocab_size), dtype=getattr(torch, cfg.dtype), device="meta"))
    if step_kind == "prefill":
        caches = mdl.init_cache(cfg, b, shape.seq_len, device="meta")
        out_sh = (logits_sh, cache_shardings(mesh, caches, cfg))
    else:
        out_sh = (logits_sh, batch_sh["caches"])
    return (p_sh, batch_sh), out_sh, (params_shape, specs)
