"""MoE training in the port against the JAX package's: the MoE FFN under a
gradient, aux loss included, for the reduced qwen2-moe-a2.7b and the
reduced deepseek-v2-lite-16b (MLA, a dense first block).

The reference's random parameters (norm scales moved off 1 by numpy
noise) carry across through ``params_from_numpy``; the same numpy tokens
go through both. The batch is 2 × 40 tokens, so the MoE's 64-token groups
are two, the second padded with 48 zero tokens that route and take queue
places. Cases: the default ``aux_weight`` 0.01, 1.0 (so the aux's own
gradient shows in every router leaf), and a capacity factor of 0.5
(capacity 16 of a group's 128 choices over 4 experts: tokens are dropped).

Tolerances (f32): the dense trainer's, loss, CE and aux to 2e-6 and each
gradient leaf to atol 2e-6 + rtol 1e-4 (the two sum the GEMMs in other
orders); 5 train steps' losses to 1e-5, gradient norms to 1e-5 relative
and the parameters after them to atol 3e-5, as the dense trainer's test.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import steps, train
from repro_torch.models import model as mdl
from repro_torch.models.layers import moe
from repro_torch.optim import adamw, schedule
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]
LOSS_ATOL = 2e-6
GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-4
STEP_TOL = 1e-5
B, S = 2, 40
DROP = 0.5  # capacity factor of the dropping case


def _configs(arch, **overrides):
    cf = overrides.pop("capacity_factor", None)
    ref, port = ref_get_config(arch, reduced=True), get_config(arch, reduced=True)
    if cf is not None:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, capacity_factor=cf))
        port = dataclasses.replace(port, moe=dataclasses.replace(port.moe, capacity_factor=cf))
    return dataclasses.replace(ref, **overrides), dataclasses.replace(port, **overrides)


@functools.cache
def _ref_params(arch):
    cfg, _ = _configs(arch)
    params = jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def nudge(path, a):  # norm scales start at 1: move them
        key = jax.tree_util.keystr(path)
        if "scale" in key or "_norm" in key:
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(nudge, params)


def _tokens(vocab, seed=2):
    batch = RefTokenPipeline(vocab, B, S, seed=seed).next_batch()
    return batch.tokens, batch.targets


@functools.cache
def _ref_grad_fn(arch, capacity_factor):
    cfg, _ = _configs(arch, capacity_factor=capacity_factor)
    return cfg, jax.jit(jax.value_and_grad(
        lambda p, t, g, w: ref_model.loss_fn(cfg, p, t, g, aux_weight=w), has_aux=True))


@functools.cache
def _ref_value_and_grad(arch, capacity_factor, aux_weight):
    cfg, fn = _ref_grad_fn(arch, capacity_factor)
    toks, tgts = _tokens(cfg.vocab_size)
    (loss, metrics), grads = fn(_ref_params(arch), toks, tgts, jnp.float32(aux_weight))
    return (float(loss), float(metrics["ce"]), float(metrics["aux"]),
            jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(cfg, arch, aux_weight):
    toks, tgts = _tokens(cfg.vocab_size)
    params = mdl.params_from_numpy(cfg, _ref_params(arch), device="cpu").requires_grad_(True)
    loss, metrics = mdl.loss_fn(cfg, params, torch.from_numpy(toks), torch.from_numpy(tgts),
                                aux_weight=aux_weight)
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return params, loss, metrics, grads


@contextlib.contextmanager
def _routes(into: list):
    """Record every ``moe.route`` call's (expert, kept) while open."""
    real = moe.route
    moe.route = lambda *a: (into.append(real(*a)), into[-1])[1]
    try:
        yield into
    finally:
        moe.route = real


CASES = {
    "aux 0.01": (None, 0.01),
    "aux 1.0": (None, 1.0),
    "dropped tokens": (DROP, 0.01),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_leaf_match_reference(arch, case):
    capacity_factor, aux_weight = CASES[case]
    _, cfg = _configs(arch, capacity_factor=capacity_factor)
    want_loss, want_ce, want_aux, want = _ref_value_and_grad(arch, capacity_factor, aux_weight)
    with _routes([]) as routes:
        params, loss, metrics, grads = _port_grads(cfg, arch, aux_weight)
    n_moe = sum(f == "moe" for _, f in cfg.all_blocks)
    assert len(routes) == n_moe and all(r.expert.shape[0] == 2 for r in routes)
    dropped = sum(int((~r.kept).sum()) for r in routes)
    assert (dropped > 0) == (capacity_factor is not None), dropped
    assert want_aux > 0
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(metrics["ce"].detach()), want_ce, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(metrics["aux"].detach()), want_aux, atol=LOSS_ATOL, rtol=0)
    got = mdl.reference_tree(params, grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))
    router = [g for (path, g) in jax.tree_util.tree_leaves_with_path(got)
              if "router" in jax.tree_util.keystr(path)]
    assert router and all(np.abs(r).max() > 0 for r in router)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_aux_term_reaches_the_router_and_not_the_experts(arch):
    """Raising aux_weight from 0.01 to 1.0 moves every router's gradient
    and leaves the routed experts', the head's and the final norm's the
    same bits: the aux loss reads the router's softmax over the layer's
    input, not the experts' outputs (the configs have one MoE layer)."""
    _, cfg = _configs(arch)
    assert sum(f == "moe" for _, f in cfg.all_blocks) == 1
    _, _, _, lo = _port_grads(cfg, arch, 0.01)
    _, _, _, hi = _port_grads(cfg, arch, 1.0)
    moved = {n for n in hi if not torch.equal(hi[n], lo[n])}
    assert {n for n in hi if n.endswith("moe.router")} <= moved
    assert not moved & {n for n in hi if n.split(".")[-1] in ("e_gate", "e_up", "e_down")}
    assert not moved & {"lm_head", "final_norm.scale"}


@pytest.mark.parametrize("capacity_factor", [None, DROP], ids=["no drops", "dropped tokens"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_routing_loss_and_gradients(arch, capacity_factor):
    """cfg.remat runs every block under torch.utils.checkpoint: on the CPU
    the recompute routes exactly as the forward did, and the loss and every
    gradient are the same bits."""
    out = []
    for remat in (False, True):
        _, cfg = _configs(arch, capacity_factor=capacity_factor, remat=remat)
        with _routes([]) as routes:
            _, loss, _, grads = _port_grads(cfg, arch, 0.01)
        out.append((loss, grads, routes))
    (loss0, g0, r0), (loss1, g1, r1) = out
    n_moe = sum(f == "moe" for _, f in cfg.all_blocks)
    assert (len(r0), len(r1)) == (n_moe, 2 * n_moe)  # the recompute routes again
    for fwd, again in ((r1[:n_moe], r1[n_moe:]), (r0, r1[:n_moe])):
        for a, b in zip(fwd, again):
            assert torch.equal(a.expert, b.expert) and torch.equal(a.kept, b.kept)
            assert torch.equal(a.gate, b.gate)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


N_STEPS = 5
LR = 3e-3
EPS = 1e-8  # AdamW's ε
TINY_GRAD = 10 * EPS


@functools.cache
def _ref_train(arch):
    """The reference's 5 steps: their metrics, the final state, and per
    parameter entry the smallest nonzero |gradient| of the 5 (from μ)."""
    cfg, _ = _configs(arch)
    opt = ref_adamw(ref_schedule.linear_warmup_cosine(LR, 1, N_STEPS), eps=EPS)
    step_fn = jax.jit(ref_steps.make_train_step(cfg, opt))
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params(arch))
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    pipe = RefTokenPipeline(cfg.vocab_size, B, S, seed=0)
    out = []
    mu = [np.zeros(a.shape, np.float32) for a in jax.tree_util.tree_leaves(params)]
    smallest = [np.full(a.shape, np.inf, np.float32) for a in mu]
    for _ in range(N_STEPS):
        bt = pipe.next_batch()
        state, m = step_fn(state, {"tokens": jnp.asarray(bt.tokens), "targets": jnp.asarray(bt.targets)})
        out.append({k: float(v) for k, v in m.items()})
        new_mu = [np.asarray(a) for a in jax.tree_util.tree_leaves(state["opt_state"]["mu"])]
        for i, (a, b) in enumerate(zip(new_mu, mu)):
            g = np.abs(a - 0.9 * b) / 0.1  # μ_t = 0.9 μ_{t-1} + 0.1 g_t
            smallest[i] = np.where(g > 0, np.minimum(smallest[i], g), smallest[i])
        mu = new_mu
    return out, jax.tree_util.tree_map(np.asarray, state), smallest


@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_steps_match_reference(arch):
    """Losses, CE, aux and gradient norms at every step, and the parameters
    after the 5 steps to atol 3e-5 (the dense trainer's limit). Where some
    step's gradient entry is nonzero but below 10·ε, AdamW's g / (√ν + ε)
    turns the gradients' last-bit differences (atol 2e-6 above) into a
    different step, so those entries (0.1–0.2 % here: biases of k that the
    softmax cancels, experts a token barely reached) are held within one
    step's size, the learning rate."""
    want, want_state, smallest = _ref_train(arch)
    _, cfg = _configs(arch)
    opt = adamw(schedule.linear_warmup_cosine(LR, 1, N_STEPS), eps=EPS)
    state = steps.init_train_state(mdl.params_from_numpy(cfg, _ref_params(arch), device="cpu"), opt)
    step_fn = steps.make_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab_size, B, S, seed=0)
    for w in want:
        bt = pipe.next_batch()
        state, m = step_fn(state, {"tokens": torch.from_numpy(bt.tokens),
                                   "targets": torch.from_numpy(bt.targets)})
        assert w["aux"] > 0
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[key]), w[key], atol=STEP_TOL, err_msg=key)
        np.testing.assert_allclose(float(m["grad_norm"]), w["grad_norm"], rtol=STEP_TOL)
    tree = steps.train_state_tree(state)
    assert int(tree["step"]) == int(want_state["step"]) == N_STEPS
    tiny = total = 0
    for (path, a), b, g in zip(jax.tree_util.tree_leaves_with_path(tree["params"]),
                               jax.tree_util.tree_leaves(want_state["params"]), smallest):
        limit = np.where(g < TINY_GRAD, LR, 3e-5)
        assert (np.abs(a - b) <= limit).all(), (jax.tree_util.keystr(path), float(np.abs(a - b).max()))
        tiny, total = tiny + int((g < TINY_GRAD).sum()), total + g.size
    assert tiny < 0.01 * total, (tiny, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_moe_arch_on_the_cpu(arch, capsys):
    train.main(["--device", "cpu", "--arch", arch, "--reduced", "--steps", "12", "--batch", "4",
                "--seq", "64", "--log-every", "5"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step    10 loss" in out and "improved: True" in out


def test_train_cli_needs_the_card_for_the_moe_arch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--steps", "1"])
