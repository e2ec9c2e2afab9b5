"""The port's LM training path against the JAX package's.

Token batches, schedules, clipping, AdamW, ``loss_fn`` and its gradients,
the flash route's backward, the train step, the train-state bundle and the
trainer's CLI. The reference's random parameters of the f32 reduced
qwen3-0.6b (norm scales moved off 1 by numpy noise) carry across through
``params_from_numpy``; the same numpy tokens go through both. The JAX side
is jitted once per config and cached for the file.

Tolerances (f32 throughout): schedules and the clipped tree to 1e-6
relative (measured ≤ 2.1e-7: the two packages' ``cos`` differ in the last
ulp); AdamW's updates and moments after 3 steps to atol 1e-9 on updates of
~3e-3 (measured ≤ 2.3e-10: the same operations in the same order); the
loss to 2e-6 (measured 4.8e-7, one ulp at 6) and each gradient leaf to
atol 2e-6 + rtol 1e-4 (measured ≤ 9e-8: the two sum the GEMMs in other
orders); the flash backward to atol 2e-5 on gradients up to 8.8 (measured
≤ 3.8e-6); 5 train steps' losses to 1e-5 and gradient norms to 1e-5
relative, the parameters after them to atol 3e-5, 1 % of one step at lr
3e-3 (measured 1.35e-5 at 8 of 65,536 entries: where ν is near ε²,
AdamW's m / (√ν + ε) amplifies the gradients' last-ulp differences).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import schedule as ref_schedule
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps, train
from repro_torch.models import model as mdl
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.optim import adamw, clip_by_global_norm, schedule
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "qwen3-0.6b"
SCHED_RTOL = 1e-6
LOSS_ATOL = 2e-6
GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-4
FLASH_GRAD_ATOL = 2e-5
STEP_TOL = 1e-5


def _configs(**overrides):
    return (dataclasses.replace(ref_get_config(ARCH, reduced=True), **overrides),
            dataclasses.replace(get_config(ARCH, reduced=True), **overrides))


@functools.cache
def _ref_params():
    cfg, _ = _configs()
    params = jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def nudge(path, a):  # norm scales start at 1: move them
        if "scale" in jax.tree_util.keystr(path) or "_norm" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(nudge, params)


def _tokens(b, s, vocab, seed=2):
    batch = RefTokenPipeline(vocab, b, s, seed=seed).next_batch()
    return batch.tokens, batch.targets


@functools.cache
def _ref_value_and_grad(fused_ce: bool, b: int, s: int):
    cfg, _ = _configs(fused_ce=fused_ce)
    toks, tgts = _tokens(b, s, cfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, g: ref_model.loss_fn(cfg, p, t, g), has_aux=True))
    (loss, metrics), grads = fn(_ref_params(), toks, tgts)
    return (float(loss), float(metrics["ce"]), float(metrics["aux"]),
            jax.tree_util.tree_map(np.asarray, grads))


# --------------------------------------------------------------------------
# data, schedules, clipping, AdamW
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,b,s,seed", [(512, 4, 64, 0), (151936, 2, 1024, 7), (97, 3, 5, 1000)])
def test_token_pipeline_batches_are_bit_equal(vocab, b, s, seed):
    ref, port = RefTokenPipeline(vocab, b, s, seed=seed), TokenPipeline(vocab, b, s, seed=seed)
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        for a, w in ((got.tokens, want.tokens), (got.targets, want.targets)):
            assert a.dtype == w.dtype
            np.testing.assert_array_equal(a, w)


SCHEDULES = {
    "constant": (lambda m: m.constant(3e-4)),
    "cosine_decay": (lambda m: m.cosine_decay(3e-3, 40, 0.1)),
    "linear_warmup_cosine": (lambda m: m.linear_warmup_cosine(3e-3, 5, 40)),
    "linear_warmup_cosine[no warmup]": (lambda m: m.linear_warmup_cosine(1e-2, 0, 7, 0.2)),
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_reference(name):
    ref_fn, port_fn = SCHEDULES[name](ref_schedule), SCHEDULES[name](schedule)
    for step in range(0, 50):
        want = float(ref_fn(jnp.asarray(step, jnp.int32)))
        got = port_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=SCHED_RTOL, atol=0)
        np.testing.assert_allclose(float(port_fn(step)), want, rtol=SCHED_RTOL, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(3)
    tree = {k: rng.normal(size=shape).astype(np.float32)
            for k, shape in (("b", (7,)), ("a", (5, 3)), ("c", (2, 2, 4)))}
    want, want_norm = ref_clip({k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
    got, got_norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=SCHED_RTOL)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=SCHED_RTOL, atol=0)
    if max_norm > float(want_norm):
        assert all(np.array_equal(got[k].numpy(), tree[k]) for k in tree)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_three_steps_match_reference(weight_decay):
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 4), "b": (4,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    ref_opt = ref_adamw(ref_schedule.linear_warmup_cosine(3e-3, 2, 10), weight_decay=weight_decay)
    opt = adamw(schedule.linear_warmup_cosine(3e-3, 2, 10), weight_decay=weight_decay)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rs, ts = ref_opt.init(rp), opt.init(tp)
    assert ts["count"].dtype == torch.int32
    for step, g in enumerate(grads):
        ru, rs = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp, step)
        tu, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, step)
        for k in shapes:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ru[k]), rtol=0, atol=1e-9)
            for m in ("mu", "nu"):
                assert ts[m][k].dtype == torch.float32
                np.testing.assert_allclose(ts[m][k].numpy(), np.asarray(rs[m][k]), rtol=0, atol=1e-9)
        rp = {k: rp[k] + ru[k] for k in shapes}
        tp = {k: tp[k] + tu[k] for k in shapes}
        assert int(ts["count"]) == int(rs["count"]) == step + 1


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------
def _port_grads(cfg, b, s):
    toks, tgts = _tokens(b, s, cfg.vocab_size)
    params = mdl.params_from_numpy(cfg, _ref_params(), device="cpu").requires_grad_(True)
    loss, metrics = mdl.loss_fn(cfg, params, torch.from_numpy(toks), torch.from_numpy(tgts))
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    return params, loss, metrics, grads


@pytest.mark.parametrize("fused_ce,b,s", [(False, 2, 64), (True, 1, 1024), (True, 2, 1536)])
def test_loss_and_every_gradient_leaf_match_reference(fused_ce, b, s):
    """fused_ce at S = 1,024 and 1,536 runs 2 and 3 chunks."""
    _, cfg = _configs(fused_ce=fused_ce)
    want_loss, want_ce, want_aux, want = _ref_value_and_grad(fused_ce, b, s)
    params, loss, metrics, grads = _port_grads(cfg, b, s)
    assert loss.dtype == torch.float32 and float(metrics["aux"]) == want_aux == 0.0
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(metrics["ce"].detach()), want_ce, atol=LOSS_ATOL, rtol=0)
    got = mdl.reference_tree(params, grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_recomputes_the_same_loss_and_gradients():
    """cfg.remat runs every block under torch.utils.checkpoint: the same
    bits on the CPU, and the flash route's forward runs again in the
    backward pass."""
    _, plain = _configs(n_layers=2)
    _, remat = _configs(n_layers=2, remat=True)
    ref_params = ref_model.init_params(_configs(n_layers=2)[0], jax.random.PRNGKey(5))
    ref_params = jax.tree_util.tree_map(np.asarray, ref_params)
    toks, tgts = (torch.from_numpy(a) for a in _tokens(2, 32, plain.vocab_size))
    out = []
    for cfg in (plain, remat):
        params = mdl.params_from_numpy(cfg, ref_params, device="cpu").requires_grad_(True)
        calls = []
        real = flash_ops.flash_attention_padded
        flash_ops.flash_attention_padded = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        try:
            loss, _ = mdl.loss_fn(cfg, params, toks, tgts)
            grads = torch.autograd.grad(loss, list(params.parameters()))
        finally:
            flash_ops.flash_attention_padded = real
        out.append((loss, grads, len(calls)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert (out[0][2], out[1][2]) == (2, 4)


def test_params_to_numpy_inverts_params_from_numpy():
    _, cfg = _configs()
    tree = _ref_params()
    back = mdl.params_to_numpy(cfg, mdl.params_from_numpy(cfg, tree, device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the flash route's backward
# --------------------------------------------------------------------------
def _qkv(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, kv, hd)).astype(np.float32),
            rng.normal(size=(b, s, h, hd)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kv,hd", [(2, 37, 4, 2, 32), (1, 70, 6, 1, 64), (1, 33, 4, 4, 128),
                                         (2, 1, 4, 2, 16)])
def test_flash_function_backward_matches_jax_gradient(b, s, h, kv, hd):
    """The Function's backward on the CPU against jax.vjp of the reference's
    attention oracle: GQA groups of 2, 6 and 1, ragged S, and S = 1."""
    q, k, v, do = _qkv(b, s, h, kv, hd)
    out, vjp = jax.vjp(lambda q, k, v: ref_attention(q, k, v, causal=True), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = flash_ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=FLASH_GRAD_ATOL)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for name, g, w in zip("qkv", grads, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLASH_GRAD_ATOL, err_msg=f"d{name}")


def test_flash_function_under_inference_mode_is_the_wrapper():
    q, k, v, _ = _qkv(1, 20, 4, 2, 32)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    with torch.inference_mode():
        got = flash_ops.flash_attention(q, k, v)
    assert torch.equal(got, flash_ops.flash_attention_padded(q, k, v))


# --------------------------------------------------------------------------
# the train step, the bundle, the CLI
# --------------------------------------------------------------------------
N_STEPS, B, S = 5, 4, 32


@functools.cache
def _ref_train():
    cfg, _ = _configs()
    opt = ref_adamw(ref_schedule.linear_warmup_cosine(3e-3, 1, N_STEPS))
    step_fn = jax.jit(ref_steps.make_train_step(cfg, opt))
    params = jax.tree_util.tree_map(jnp.asarray, _ref_params())
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    pipe = RefTokenPipeline(cfg.vocab_size, B, S, seed=0)
    out = []
    for _ in range(N_STEPS):
        bt = pipe.next_batch()
        state, m = step_fn(state, {"tokens": jnp.asarray(bt.tokens), "targets": jnp.asarray(bt.targets)})
        out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree_util.tree_map(np.asarray, state)


def test_five_train_steps_match_reference():
    want, want_state = _ref_train()
    _, cfg = _configs()
    opt = adamw(schedule.linear_warmup_cosine(3e-3, 1, N_STEPS))
    state = steps.init_train_state(mdl.params_from_numpy(cfg, _ref_params(), device="cpu"), opt)
    step_fn = steps.make_train_step(cfg, opt)
    pipe = TokenPipeline(cfg.vocab_size, B, S, seed=0)
    for w in want:
        bt = pipe.next_batch()
        state, m = step_fn(state, {"tokens": torch.from_numpy(bt.tokens),
                                   "targets": torch.from_numpy(bt.targets)})
        np.testing.assert_allclose(float(m["loss"]), w["loss"], atol=STEP_TOL)
        np.testing.assert_allclose(float(m["ce"]), w["ce"], atol=STEP_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), w["grad_norm"], rtol=STEP_TOL)
    tree = steps.train_state_tree(state)
    assert int(tree["step"]) == int(want_state["step"]) == N_STEPS
    assert int(tree["opt_state"]["count"]) == N_STEPS
    for a, b in zip(jax.tree_util.tree_leaves(tree["params"]),
                    jax.tree_util.tree_leaves(want_state["params"])):
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=0)


def test_train_state_bundle_is_read_by_the_reference(tmp_path):
    """A bundle written by the port's trainer restores in the reference
    against its own train state's structure, and in the port."""
    path = str(tmp_path / "state.npz")
    train.main(["--device", "cpu", "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
                "--checkpoint", path])
    cfg, port_cfg = _configs()
    opt = ref_adamw(3e-3)
    params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    ref_state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    restored, step, _ = ref_restore(path, ref_state)
    assert step == 3 and int(restored["step"]) == 3 and int(restored["opt_state"]["count"]) == 3
    state, _ = train.train(port_cfg, steps=3, batch=2, seq=16, lr=3e-3, device="cpu", log=lambda s: None)
    want = steps.train_state_tree(state)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    mine, _, _ = restore_checkpoint(path, want)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_train_cli_runs_on_the_cpu(capsys):
    train.main(["--device", "cpu", "--reduced", "--steps", "6", "--batch", "2", "--seq", "16",
                "--log-every", "5"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     5 loss" in out
    assert "loss: first5=" in out and "improved: True" in out


def test_train_cli_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])


def test_prefill_and_serve_steps_match_the_model():
    _, cfg = _configs()
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=12, global_batch=2)
    params = mdl.params_from_numpy(cfg, _ref_params(), device="cpu")
    toks = torch.from_numpy(_tokens(2, 12, cfg.vocab_size)[0]).long()
    (prefill, kind) = steps.make_step(cfg, shape)
    assert kind == "prefill"
    logits, caches = prefill(params, {"tokens": toks})
    with torch.inference_mode():
        hidden, _, _ = mdl.forward(cfg, params, toks)
        want = mdl.logits_from_hidden(cfg, params, hidden)[:, -1]
    # the last position alone through the head: a GEMM of another shape, the
    # f32 logit tolerance of test_torch_lm_model.py
    torch.testing.assert_close(logits, want, atol=2e-5, rtol=0)
    assert caches["pos"] == 12
    dshape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=12, global_batch=2)
    serve, kind = steps.make_step(cfg, dshape)
    assert kind == "decode"
    with torch.inference_mode():
        c = mdl.init_cache(cfg, 2, 13, device="cpu")
        _, c, _ = mdl.forward(cfg, params, toks, caches=c)
    step_logits, c = serve(params, {"token": logits.argmax(-1, keepdim=True), "caches": c})
    assert tuple(step_logits.shape) == (2, cfg.vocab_size) and c["pos"] == 13
    assert steps.make_step(cfg, INPUT_SHAPES["train_4k"])[1] == "train"


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-1.5b", "llama3.2-3b", "deepseek-v2-lite-16b"])
def test_decode_window_and_cache_len_match_reference(arch, shape):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    from repro.models.config import INPUT_SHAPES as REF_SHAPES

    assert steps.decode_window_for(cfg, INPUT_SHAPES[shape]) == ref_steps.decode_window_for(
        ref_cfg, REF_SHAPES[shape])
    assert steps.cache_len_for(cfg, INPUT_SHAPES[shape]) == ref_steps.cache_len_for(
        ref_cfg, REF_SHAPES[shape])
