"""The port's RG-LRU block (``models/layers/rglru.py``), its local
attention and the recurrentgemma-9b serve and train paths against the JAX
package's.

The reduced recurrentgemma-9b (5 layers: the (rglru, rglru, local) period
and the two trailing rglru blocks; d_model and lru width 128, 4 heads with
one kv head of 32, window 16) with the reference's random parameters,
every bias and norm scale moved off its init value, carried across with
``params_from_numpy``; the same numpy inputs go through both.

Tolerances: f32 outputs, states, hidden states and logits to atol 2e-5
(the scan's pairings are the reference's ``associative_scan``'s, the GEMMs
sum in other orders), the model's caches also to 1e-5 relative (the
xLSTM file's limit, shared); greedy tokens equal; bf16 to atol 0.1, the dense
model's bf16 limit (both round at the same places, the products at
others); the loss to 2e-6 and every gradient leaf to atol 2e-6 + rtol
1e-4, the dense trainer's limits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_recurrent import (BF16_ATOL, F32_ATOL, assert_caches_equal, assert_loss_and_grads_match,
                              assert_round_trip, configs, nudge, port_params, reference_run,
                              torch_tree)

from repro.models import model as ref_model
from repro.models.layers import rglru as ref_rglru
from repro_torch.launch import serve, train
from repro_torch.models import model as mdl
from repro_torch.models.layers import rglru
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "recurrentgemma-9b"
B = 2
ATOL = {"float32": F32_ATOL, "bfloat16": BF16_ATOL}


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------
@functools.cache
def _block_params():
    ref_cfg, _ = configs(ARCH)
    params = jax.tree_util.tree_map(np.asarray, ref_rglru.init_rglru_block(ref_cfg, jax.random.PRNGKey(3)))
    return jax.tree_util.tree_map_with_path(nudge(np.random.default_rng(4)), params)


def _x(shape, seed=5):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero start", "h0"])
@pytest.mark.parametrize("s", [13, 16])
def test_rglru_scan_matches_reference(s, h0, dtype):
    """An odd and a power-of-two length through the scan's recursion; the
    output in the input's dtype, the last state in f32."""
    params = _block_params()
    w = params["w_r"].shape[0]
    x = _x((B, s, w))
    start = _x((B, w), seed=6) if h0 else None
    jdt = jnp.dtype(dtype)
    want_y, want_h = jax.jit(ref_rglru.rglru_scan)(params, jnp.asarray(x, jdt),
                                                   None if start is None else jnp.asarray(start))
    tdt = getattr(torch, dtype)
    y, h = rglru.rglru_scan(torch_tree(params), torch.from_numpy(x).to(tdt),
                            None if start is None else torch.from_numpy(start))
    assert y.dtype == tdt and h.dtype == torch.float32
    assert tuple(y.shape) == (B, s, w) and tuple(h.shape) == (B, w)
    _close(y, want_y, dtype)
    _close(h, want_h, dtype)


def test_rglru_step_matches_reference():
    params = _block_params()
    w = params["w_r"].shape[0]
    x, h = _x((B, w)), _x((B, w), seed=7)
    want = ref_rglru.rglru_step(params, jnp.asarray(x), jnp.asarray(h))
    got = rglru.rglru_step(torch_tree(params), torch.from_numpy(x), torch.from_numpy(h))
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tail", [False, True], ids=["zero tail", "tail"])
def test_conv1d_causal_matches_reference(tail, dtype):
    params = _block_params()
    cw, w = params["conv_w"].shape
    x = _x((B, 9, w))
    t = _x((B, cw - 1, w), seed=8) if tail else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref_rglru.conv1d_causal(params, jnp.asarray(x, jdt), None if t is None else jnp.asarray(t, jdt))
    got = rglru.conv1d_causal(torch_tree(params), torch.from_numpy(x).to(tdt),
                              None if t is None else torch.from_numpy(t).to(tdt))
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_full_then_decode_matches_reference(dtype):
    """The whole sequence, its final state, then 3 decode steps carrying it."""
    ref_cfg, cfg = configs(ARCH, dtype=dtype)
    params = _block_params()
    s = 11
    x = _x((B, s + 3, cfg.d_model), seed=9)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    block = jax.jit(lambda p, x, st: ref_rglru.rglru_block(ref_cfg, p, x, st))
    want_y, st = block(params, jnp.asarray(x[:, :s], jdt), None)
    tp = torch_tree(params)
    y, got = rglru.rglru_block(cfg, tp, torch.from_numpy(x[:, :s]).to(tdt), None)
    _close(y, want_y, dtype)
    assert got["h"].dtype == torch.float32 and got["conv"].dtype == tdt
    for key in ("h", "conv"):
        _close(got[key], st[key], dtype)
    for t in range(s, s + 3):
        want_y, st = block(params, jnp.asarray(x[:, t:t + 1], jdt), st)
        y, got = rglru.rglru_block(cfg, tp, torch.from_numpy(x[:, t:t + 1]).to(tdt), got)
        _close(y, want_y, dtype)
        for key in ("h", "conv"):
            _close(got[key], st[key], dtype)


def test_init_rglru_block_has_the_reference_leaves_and_decays():
    ref_cfg, cfg = configs(ARCH)
    want = ref_rglru.init_rglru_block(ref_cfg, jax.random.PRNGKey(0))
    got = rglru.init_rglru_block(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(want["lam"]), rtol=1e-5)
    state = rglru.init_rglru_state(cfg, 3, torch.bfloat16, "cpu")
    want_state = ref_rglru.init_rglru_state(ref_cfg, 3, jnp.bfloat16)
    for key in ("h", "conv"):
        assert tuple(state[key].shape) == want_state[key].shape
    assert state["h"].dtype == torch.float32 and state["conv"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the model: reduced recurrentgemma-9b, past its window of 16
# --------------------------------------------------------------------------
P, GEN = 19, 6  # the prefill rolls the ring by 19 mod 16; decode runs to 24


def _clone(caches):
    return {"layers": [{k: v.clone() if torch.is_tensor(v) else v for k, v in layer.items()}
                       for layer in caches["layers"]], "pos": caches["pos"]}


def _port_run(items=(), p=P, gen=GEN):
    """The port's prefill into a cache of p + gen and gen - 1 decode steps
    fed the reference's tokens: (hidden, logits, prefill caches, per-step
    logits, final caches)."""
    ref = reference_run(ARCH, items, B, p, gen)
    cfg, params = port_params(ARCH, items)
    with torch.inference_mode():
        caches = mdl.init_cache(cfg, B, p + gen, device="cpu")
        hidden, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long(), caches=caches)
        logits = mdl.logits_from_hidden(cfg, params, hidden)
        prefill = _clone(caches)
        steps = [logits[:, -1]]
        for t in range(1, gen):
            tok = torch.from_numpy(ref["tokens"][:, t - 1:t]).long()
            step, caches = mdl.decode_step(cfg, params, tok, caches)
            steps.append(step)
    return ref, cfg, hidden, logits, prefill, torch.stack(steps), caches


def test_forward_matches_reference():
    ref, _, hidden, logits, _, _, _ = _port_run()
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=F32_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32_ATOL)


def test_prefill_then_decode_matches_reference_at_every_step_past_the_window():
    ref = reference_run(ARCH, (), B, P, GEN)
    cfg, params = port_params(ARCH)
    assert P > cfg.sliding_window and cfg.sliding_window == 16
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    assert tuple(steps.shape) == (GEN, B, cfg.vocab_size)
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=F32_ATOL)
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])


def test_caches_and_states_match_reference_after_prefill_and_decode():
    """The local block's ring (16 slots, rolled by 19 mod 16) and each
    recurrent block's h and conv tail, after the prefill and after the 5
    decode steps."""
    ref, cfg, _, _, prefill, steps, final = _port_run()
    assert [tuple(sorted(c)) for c in prefill["layers"]] == (
        [("conv", "h")] * 2 + [("k", "pos", "v")] + [("conv", "h")] * 2)
    assert tuple(prefill["layers"][2]["k"].shape) == (B, cfg.sliding_window, 1, 32)
    assert_caches_equal(cfg, prefill, ref["caches"])
    assert_caches_equal(cfg, final, ref["final_caches"])
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=F32_ATOL)


def test_a_short_prompt_ends_where_the_reference_does():
    """A 2-token prompt: the prefill's logits and states equal the
    reference's, the conv tail keeps the 2 rows there are (of cw - 1 = 3),
    and the first decode step fails in both packages (ROADMAP Queue C)."""
    ref = reference_run(ARCH, (), B, 2, 1)
    cfg, params = port_params(ARCH)
    with torch.inference_mode():
        caches = mdl.init_cache(cfg, B, 3, device="cpu")
        hidden, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long(), caches=caches)
    np.testing.assert_allclose(mdl.logits_from_hidden(cfg, params, hidden).numpy(), ref["logits"],
                               atol=F32_ATOL)
    assert tuple(caches["layers"][0]["conv"].shape) == (B, 2, cfg.d_model)
    assert_caches_equal(cfg, caches, ref["caches"])
    tok = torch.from_numpy(ref["tokens"]).long()
    with pytest.raises(IndexError):
        mdl.decode_step(cfg, params, tok, caches)
    ref_cfg, _ = configs(ARCH)
    ref_caches = jax.tree_util.tree_map(jnp.asarray, ref["caches"])
    with pytest.raises(IndexError):
        ref_model.decode_step(ref_cfg, ref["params"], jnp.asarray(ref["tokens"]), ref_caches)


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
    assert all(float(g.abs().max()) > 0 for n, g in grads.items() if ".rec." in n)


def test_params_round_trip_key_for_key():
    got = assert_round_trip(ARCH)
    assert {"/stack/pos0/rec/lam", "/stack/pos2/attn/wq", "/tail/1/rec/conv_w",
            "/tail/0/ffn_norm/scale"} <= got


def test_serve_and_train_clis_run_recurrentgemma_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "18", "--gen", "3"])
    train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "4", "--batch", "2",
                "--seq", "32", "--log-every", "3"])
    out = capsys.readouterr().out
    assert "prefill (2x18)" in out and "decoded 2 x 2 tokens" in out
    assert "step     0 loss" in out and "step     3 loss" in out


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs(ARCH)
    for fn in (lambda: serve.main(["--arch", ARCH, "--reduced"]),
               lambda: train.main(["--arch", ARCH, "--reduced", "--steps", "1"]),
               lambda: mdl.init_params(cfg), lambda: mdl.init_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
