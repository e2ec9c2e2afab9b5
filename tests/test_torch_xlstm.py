"""The port's xLSTM blocks (``models/layers/xlstm.py``) and the xlstm-125m
serve and train paths against the JAX package's.

The reduced xlstm-125m (2 layers: one mLSTM block, d_in 256 in 4 heads of
64, and one sLSTM block, d_in 168 in 4 heads of 42; d_model 128, no FFN,
no rotary angles) with the reference's random parameters, every bias and
norm scale moved off its init value, carried across with
``params_from_numpy``; the same numpy inputs go through both. The
chunkwise mLSTM runs with ``mlstm_chunk`` 8 on a 24-token sequence.

Tolerances: f32 outputs, states, hidden states and logits to atol 2e-5
(the GEMMs and einsums sum in other orders), the model's caches also to
1e-5 relative (the sLSTM's normalizer n, a running sum of exp'd gates,
reaches 9 in 24 steps and differs by up to 2.7e-5 there); greedy tokens
equal; bf16 to
atol 0.1, the dense model's bf16 limit; the loss to 2e-6 and every
gradient leaf to atol 2e-6 + rtol 1e-4, the dense trainer's limits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_recurrent import (BF16_ATOL, F32_ATOL, GRAD_ATOL, GRAD_RTOL, assert_caches_equal,
                              assert_loss_and_grads_match, assert_round_trip, configs, nudge,
                              port_params, reference_run, torch_tree)

from repro.models.layers import xlstm as ref_xlstm
from repro_torch.launch import serve, train
from repro_torch.models import model as mdl
from repro_torch.models.layers import xlstm
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "xlstm-125m"
B, S, CHUNK = 2, 24, 8
ATOL = {"float32": F32_ATOL, "bfloat16": BF16_ATOL}


@functools.cache
def _params(kind):
    ref_cfg, _ = configs(ARCH)
    init = {"mlstm": ref_xlstm.init_mlstm_block, "slstm": ref_xlstm.init_slstm_block}[kind]
    params = jax.tree_util.tree_map(np.asarray, init(ref_cfg, jax.random.PRNGKey(3)))
    return jax.tree_util.tree_map_with_path(nudge(np.random.default_rng(4)), params)


def _x(shape, seed=5):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=ATOL[dtype])


def _close_state(got, want, dtype="float32"):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        _close(got[key], want[key], dtype)


def _z(cfg, s=S, seed=5):
    d_in, _ = xlstm._mlstm_dims(cfg)
    return _x((B, s, d_in), seed)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_parallel_matches_reference(dtype):
    ref_cfg, cfg = configs(ARCH, dtype=dtype)
    params = _params("mlstm")
    z = _z(cfg)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, want_state = jax.jit(lambda p, z: ref_xlstm.mlstm_parallel(ref_cfg, p, z))(params, jnp.asarray(z, jdt))
    got, state = xlstm.mlstm_parallel(cfg, torch_tree(params), torch.from_numpy(z).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (B, S, z.shape[-1])
    _close(got, want, dtype)
    _close_state(state, want_state, dtype)


def test_mlstm_chunkwise_matches_reference_and_the_parallel_form():
    ref_cfg, cfg = configs(ARCH, mlstm_chunk=CHUNK)
    params = _params("mlstm")
    z = _z(cfg)
    want, want_state = jax.jit(lambda p, z: ref_xlstm.mlstm_chunkwise(ref_cfg, p, z, CHUNK))(params, z)
    tp = torch_tree(params)
    got, state = xlstm.mlstm_chunkwise(cfg, tp, torch.from_numpy(z), CHUNK)
    _close(got, want)
    _close_state(state, want_state)
    whole, whole_state = xlstm.mlstm_parallel(cfg, tp, torch.from_numpy(z))
    torch.testing.assert_close(got, whole, atol=F32_ATOL, rtol=0)
    for key in whole_state:
        torch.testing.assert_close(state[key], whole_state[key], atol=F32_ATOL, rtol=0)
    with pytest.raises(ValueError, match="multiple"):
        xlstm.mlstm_chunkwise(cfg, tp, torch.from_numpy(z[:, :S - 1]), CHUNK)


def test_mlstm_steps_match_reference_and_the_parallel_state():
    """S steps of mlstm_step from the zero state: each step's output and the
    state against the reference's steps, and the last state against the
    parallel form's final state (the stabilizer's induction)."""
    ref_cfg, cfg = configs(ARCH)
    params = _params("mlstm")
    z = _z(cfg, s=10)
    step = jax.jit(lambda p, z, st: ref_xlstm.mlstm_step(ref_cfg, p, z, st))
    want_state = ref_xlstm.init_mlstm_state(ref_cfg, B)
    tp = torch_tree(params)
    state = xlstm.init_mlstm_state(cfg, B, "cpu")
    outs = []
    for t in range(z.shape[1]):
        want, want_state = step(params, jnp.asarray(z[:, t:t + 1]), want_state)
        got, state = xlstm.mlstm_step(cfg, tp, torch.from_numpy(z[:, t:t + 1]), state)
        _close(got, want)
        _close_state(state, want_state)
        outs.append(got)
    whole, whole_state = xlstm.mlstm_parallel(cfg, tp, torch.from_numpy(z))
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, atol=F32_ATOL, rtol=0)
    for key in whole_state:
        torch.testing.assert_close(state[key], whole_state[key], atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_mlstm_gradient_through_the_masked_decay_is_finite_and_matches(form):
    """d(mean out·r + mean C + mean n)/d(z, params) (a loss of the size of
    the CE, so the gradient limits apply) through the −∞ causal mask: finite,
    and the reference's ``jax.grad`` of the same function. Shifting every ĩ
    by one constant leaves out, C and n as they are (the stabilizer m takes
    the shift), so b_i's true gradient is near 0 and both packages' f32
    values of it are the residue of terms of the size of the others that
    cancel: it is held to
    GRAD_RTOL of the largest gradient entry."""
    ref_cfg, cfg = configs(ARCH)
    params = _params("mlstm")
    z = _z(cfg)
    r = _x((B, S, z.shape[-1]), seed=11)
    fns = {"parallel": (lambda c, p, z: ref_xlstm.mlstm_parallel(c, p, z),
                        lambda c, p, z: xlstm.mlstm_parallel(c, p, z)),
           "chunkwise": (lambda c, p, z: ref_xlstm.mlstm_chunkwise(c, p, z, CHUNK),
                         lambda c, p, z: xlstm.mlstm_chunkwise(c, p, z, CHUNK))}[form]

    def ref_loss(p, z):
        out, st = fns[0](ref_cfg, p, z)
        return jnp.mean(out * r) + jnp.mean(st["C"]) + jnp.mean(st["n"])

    want_p, want_z = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(params, jnp.asarray(z))
    largest = max(float(np.abs(np.asarray(a)).max()) for a in jax.tree_util.tree_leaves((want_p, want_z)))
    tp = {k: v.requires_grad_(True) for k, v in torch_tree(params).items()}
    tz = torch.from_numpy(z).requires_grad_(True)
    out, st = fns[1](cfg, tp, tz)
    loss = (out * torch.from_numpy(r)).mean() + st["C"].mean() + st["n"].mean()
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[n] for n in names] + [tz], allow_unused=True)
    for name, g in zip(names + ["z"], grads):
        want = want_z if name == "z" else want_p[name]
        if g is None:  # the block's projections around the cell
            assert name in ("w_up", "w_gate", "w_down") and not np.asarray(want).any(), name
            continue
        assert bool(torch.isfinite(g).all()), name
        atol = GRAD_RTOL * largest if name == "b_i" else GRAD_ATOL
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=atol, rtol=GRAD_RTOL,
                                   err_msg=name)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def test_slstm_cell_matches_reference():
    ref_cfg, cfg = configs(ARCH)
    params = _params("slstm")
    d_in, _ = xlstm._slstm_dims(cfg)
    proj = {g: _x((B, d_in), seed=20 + i) for i, g in enumerate("zifo")}
    state = {k: _x((B, d_in), seed=30 + i) for i, k in enumerate("cnmh")}
    state["n"] = np.abs(state["n"])
    want = ref_xlstm._slstm_cell(params, proj, state, cfg.n_heads)
    got = xlstm._slstm_cell(torch_tree(params), torch_tree(proj), torch_tree(state), cfg.n_heads)
    _close_state(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_full_then_decode_matches_reference(dtype):
    ref_cfg, cfg = configs(ARCH, dtype=dtype)
    params = _params("slstm")
    s = 11
    x = _x((B, s + 3, cfg.d_model), seed=9)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    block = jax.jit(lambda p, x, st: ref_xlstm.slstm_block(ref_cfg, p, x, st))
    want_y, st = block(params, jnp.asarray(x[:, :s], jdt), None)
    tp = torch_tree(params)
    y, got = xlstm.slstm_block(cfg, tp, torch.from_numpy(x[:, :s]).to(tdt), None)
    assert y.dtype == tdt
    _close(y, want_y, dtype)
    _close_state(got, st, dtype)
    for t in range(s, s + 3):
        want_y, st = block(params, jnp.asarray(x[:, t:t + 1], jdt), st)
        y, got = xlstm.slstm_block(cfg, tp, torch.from_numpy(x[:, t:t + 1]).to(tdt), got)
        _close(y, want_y, dtype)
        _close_state(got, st, dtype)


def test_inits_have_the_reference_leaves():
    ref_cfg, cfg = configs(ARCH)
    gen = torch.Generator().manual_seed(0)
    for kind, init, ref_init in (("mlstm", xlstm.init_mlstm_block, ref_xlstm.init_mlstm_block),
                                 ("slstm", xlstm.init_slstm_block, ref_xlstm.init_slstm_block)):
        want = ref_init(ref_cfg, jax.random.PRNGKey(0))
        got = init(cfg, gen, "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}, kind
        assert torch.equal(got["b_f"], torch.full_like(got["b_f"], 3.0)), kind
    for got, want in ((xlstm.init_mlstm_state(cfg, 3, "cpu"), ref_xlstm.init_mlstm_state(ref_cfg, 3)),
                      (xlstm.init_slstm_state(cfg, 3, "cpu"), ref_xlstm.init_slstm_state(ref_cfg, 3))):
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# the model: reduced xlstm-125m
# --------------------------------------------------------------------------
P, GEN = 19, 6
CASES = {"parallel": ((), P), f"chunkwise {CHUNK}": ((("mlstm_chunk", CHUNK),), S)}


def _port_run(items, p):
    ref = reference_run(ARCH, items, B, p, GEN)
    cfg, params = port_params(ARCH, items)
    with torch.inference_mode():
        caches = mdl.init_cache(cfg, B, p + GEN, device="cpu")
        hidden, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long(), caches=caches)
        logits = mdl.logits_from_hidden(cfg, params, hidden)
        prefill = caches
        steps = [logits[:, -1]]
        for t in range(1, GEN):
            step, caches = mdl.decode_step(cfg, params, torch.from_numpy(ref["tokens"][:, t - 1:t]).long(),
                                           caches)
            steps.append(step)
    return ref, cfg, hidden, logits, prefill, torch.stack(steps), caches


@pytest.mark.parametrize("case", CASES)
def test_forward_decode_and_states_match_reference(case):
    """Hidden states and logits; the prefill's recurrent states (mLSTM C, n,
    m and sLSTM c, n, m, h) and those after the 5 decode steps; every
    step's logits."""
    ref, cfg, hidden, logits, prefill, steps, final = _port_run(*CASES[case])
    assert mdl.make_angles(cfg, torch.arange(3)) is None
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=F32_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32_ATOL)
    assert [tuple(sorted(c)) for c in prefill["layers"]] == [("C", "m", "n"), ("c", "h", "m", "n")]
    assert_caches_equal(cfg, prefill, ref["caches"])
    assert_caches_equal(cfg, final, ref["final_caches"])
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=F32_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_greedy_generation_matches_reference(case):
    items, p = CASES[case]
    ref = reference_run(ARCH, items, B, p, GEN)
    cfg, params = port_params(ARCH, items)
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=F32_ATOL)


def test_bf16_prefill_and_decode_match_reference():
    items = (("dtype", "bfloat16"),)
    ref = reference_run(ARCH, items, B, P, GEN)
    cfg, params = port_params(ARCH, items)
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    assert steps.dtype == torch.bfloat16
    np.testing.assert_allclose(steps[0].float().numpy(), ref["steps"][0], atol=BF16_ATOL)
    np.testing.assert_array_equal(tokens[:, 0].numpy(), ref["tokens"][:, 0])
    if np.array_equal(tokens.numpy(), ref["tokens"]):
        np.testing.assert_allclose(steps.float().numpy(), ref["steps"], atol=BF16_ATOL)


@pytest.mark.parametrize("remat", [False, True], ids=["remat off", "remat on"])
def test_loss_and_every_gradient_leaf_match_reference(remat):
    grads = assert_loss_and_grads_match(ARCH, remat=remat)
    assert all(float(g.abs().max()) > 0 for n, g in grads.items() if n.split(".")[-1].startswith("r_"))


def test_params_round_trip_key_for_key_with_no_ffn():
    got = assert_round_trip(ARCH)
    assert {"/stack/pos0/rec/wq", "/stack/pos1/rec/r_z", "/stack/pos1/rec/out_norm"} <= got
    assert not any("ffn_norm" in k or "mlp" in k for k in got)
    _, params = port_params(ARCH)
    assert [sorted(b) for b in params.blocks] == [["norm1", "rec"]] * 2


def test_serve_and_train_clis_run_xlstm_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "4", "--batch", "2",
                "--seq", "16", "--log-every", "3"])
    out = capsys.readouterr().out
    assert "prefill (2x9)" in out and "decoded 2 x 2 tokens" in out
    assert "step     0 loss" in out and "step     3 loss" in out


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs(ARCH)
    cfg = dataclasses.replace(cfg)
    for fn in (lambda: serve.main(["--arch", ARCH, "--reduced"]),
               lambda: train.main(["--arch", ARCH, "--reduced", "--steps", "1"]),
               lambda: mdl.init_params(cfg), lambda: mdl.init_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
