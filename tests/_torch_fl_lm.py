"""Shared helpers of the federated-LM parity tests (``test_torch_fl_lm*.py``).

The narrow reduced configs of both packages, the reference's random
parameters (cached), the samplers by case name, a recorder of each round's
draw and plan, and whole ``run_federated_lm`` runs: the reference's cached
once per (sampler, arch) for the test process, the port's run with the
reference's parameters carried across (its ``init_params`` monkeypatched to
``params_from_numpy`` of them, as ``test_torch_experiment.py`` does for
``init_mlp``). Both draw the same per-client ``TokenPipeline`` batches.

Tolerances: a round step's parameters and updates to atol 2e-6 on entries
up to 0.05 (measured ≤ 1.2e-7: the GEMMs sum in other orders); per-round
losses to atol 1e-5 (measured 4.8e-7 for every sampler), and the sampler's
draws and Algorithm 2's plans (``r_tokens``, the urn tokens) equal every
round, unsketched and with the SRP sketch.
"""
import contextlib
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.core import ClientPopulation as RefPopulation
from repro.fl.aggregation import flatten_params as ref_flatten
from repro.launch import fl_train as ref_fl
from repro.models import model as ref_model
from repro_torch.configs import get_config
from repro_torch.core import ClientPopulation
from repro_torch.launch import fl_train
from repro_torch.models import model as mdl

NARROW = dict(d_model=64, vocab_size=256, n_heads=2, n_kv_heads=2, head_dim=32)
# the reduced MoE, recurrent and VLM configs at the same d_model and vocab
# (their other widths as reduced; the VLM's 4 heads of 16 take M-RoPE
# sections of 8 pairs, split as the reduced config splits its 16)
NARROWED = {"qwen3-0.6b": NARROW, "deepseek-v2-lite-16b": dict(d_model=64, vocab_size=256),
            "qwen2-moe-a2.7b": dict(d_model=64, vocab_size=256),
            "xlstm-125m": dict(d_model=64, vocab_size=256),
            "qwen2-vl-2b": dict(d_model=64, vocab_size=256, mrope_sections=(4, 2, 2))}
STEP_ATOL = 2e-6
LOSS_ATOL = 1e-5
FL = dict(n_clients=12, m=4, n_rounds=4, n_local_steps=2, local_batch=2, seq_len=16, lr=0.1)
SIZES = np.array([300, 120, 800, 450, 90, 600, 210, 1000, 75, 330, 520, 260])
SAMPLERS = {
    "md": ("md", "sync"),
    "algorithm1": ("algorithm1", "sync"),
    "algorithm2": ("algorithm2", "sync"),
    "algorithm2[srp]": ("algorithm2", {"mode": "sync", "sketch": "srp", "sketch_dim": 16}),
}


def configs(arch="qwen3-0.6b", **overrides):
    kw = {**NARROWED.get(arch, {}), **overrides}
    return (dataclasses.replace(ref_get_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


@functools.cache
def ref_params(arch="qwen3-0.6b", n_layers=None, seed=0):
    overrides = {} if n_layers is None else {"n_layers": n_layers}
    cfg, _ = configs(arch, **overrides)
    return jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.PRNGKey(seed)))


def record_plans(sampler):
    plans, real = [], sampler.sample

    def sample(t, *a, **kw):
        plan = getattr(sampler, "plan", None)
        plans.append(None if plan is None else np.array(plan.r_tokens))
        res = real(t, *a, **kw)
        plans[-1] = (plans[-1], np.asarray(res.clients).copy())
        return res

    sampler.sample = sample
    return plans


@functools.cache
def ref_run(name, arch="qwen3-0.6b"):
    sampler_name, planner = SAMPLERS[name]
    cfg, _ = configs(arch)
    fl = ref_fl.FLLMConfig(**FL, sampler=sampler_name, planner=planner)
    d = int(ref_flatten(ref_params(arch)).shape[0])
    with contextlib.closing(ref_fl.make_lm_sampler(fl, RefPopulation(SIZES), update_dim=d)) as sm:
        plans = record_plans(sm)
        losses = ref_fl.run_federated_lm(cfg, fl, sm)
    return losses, plans


def assert_run_matches_the_reference(arch, name, monkeypatch):
    """A whole ``run_federated_lm`` of ``arch`` under sampler case ``name``
    against the reference's: per-round losses to LOSS_ATOL, equal draws and
    plans every round, and under Algorithm 2 a plan off its cold start."""
    want_losses, want_plans = ref_run(name, arch)
    sampler_name, planner = SAMPLERS[name]
    _, cfg = configs(arch)
    seen = []

    def init_params(c, seed=0, *, device="cuda"):
        seen.append(seed)
        return mdl.params_from_numpy(c, ref_params(arch), device=device)

    monkeypatch.setattr(mdl, "init_params", init_params)
    fl = fl_train.FLLMConfig(**FL, sampler=sampler_name, planner=planner)
    d = int(mdl.flatten_lm(init_params(cfg, device="cpu")).numel())
    with contextlib.closing(fl_train.make_lm_sampler(fl, ClientPopulation(SIZES), update_dim=d,
                                                     device="cpu")) as sm:
        plans = record_plans(sm)
        losses = fl_train.run_federated_lm(cfg, fl, sm, device="cpu")
    assert seen[-1] == fl.seed
    np.testing.assert_allclose(losses, want_losses, atol=LOSS_ATOL, rtol=0)
    assert len(plans) == len(want_plans) == FL["n_rounds"]
    for t, ((plan, clients), (want_plan, want_clients)) in enumerate(zip(plans, want_plans)):
        np.testing.assert_array_equal(clients, want_clients, err_msg=f"round {t}")
        if want_plan is None:
            assert plan is None
        else:
            np.testing.assert_array_equal(plan, want_plan, err_msg=f"round {t}")
    if sampler_name == "algorithm2":  # the plan moved off its cold start
        assert any(not np.array_equal(p, plans[0][0]) for p, _ in plans[1:])
