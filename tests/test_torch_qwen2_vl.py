"""The port's qwen2-vl-2b (M-RoPE, vision embeddings) against the JAX
package's.

The reduced qwen2-vl-2b (one ``("attn", "mlp")`` layer; d_model 128, 4
heads with 2 kv heads of 32, QKV biases, M-RoPE sections (6, 5, 5) of the
16 rotation pairs, 4 vision slots, tied head) with the reference's random
parameters, every bias and norm scale moved off its init value, carried
across with ``params_from_numpy``; the same random numpy vision embeddings
and tokens go through both (``tests/_torch_recurrent.py``).

Tolerances: M-RoPE's angles to atol 1e-6 for each 40 rad of the largest
angle (the two ``rope_freqs`` differ in the last bit; measured 3.7e-9 at
80 rad), and on text positions the port's
M-RoPE equals its ``rope_angles`` element for element; f32 hidden states,
logits and caches to atol 2e-5, caches also to 1e-5 relative; greedy
tokens equal; bf16 logits to atol 0.1 with tokens equal wherever the
reference's top-2 margin exceeds 0.2; the loss to 2e-6 and every gradient
leaf to atol 2e-6 + rtol 1e-4; a train step's loss to 2e-6 and gradient
norm to 1e-5 relative; flat vectors bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_recurrent import (BF16_ATOL, F32_ATOL, assert_caches_equal, assert_loss_and_grads_match,
                              assert_round_trip, configs, extras, port_params, ref_params,
                              reference_run, torch_extras)

from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.models.layers import rotary as ref_rotary
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.launch import serve, steps, train
from repro_torch.models import model as mdl
from repro_torch.models.layers import rotary
from repro_torch.optim import adamw
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "qwen2-vl-2b"
B, P, GEN = 2, 19, 6
BF16_MARGIN = 0.2
MROPE_ATOL = 1e-6


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("hd,theta,sections", [(128, 1e6, (16, 24, 24)), (32, 1e6, (6, 5, 5)),
                                               (64, 1e4, (32, 0, 0))])
def test_mrope_angles_match_the_reference(hd, theta, sections):
    """Three different streams (t, 2t, t mod 7), over a leading batch axis
    too; qwen2-vl's sections, the reduced config's, and one stream alone."""
    rng = np.random.default_rng(0)
    pos = np.stack([np.arange(40), 2 * np.arange(40), np.arange(40) % 7]).astype(np.int32)
    batched = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
    for p in (pos, batched):
        want = np.asarray(ref_rotary.mrope_angles(jnp.asarray(p), hd, theta, sections))
        got = rotary.mrope_angles(torch.from_numpy(p), hd, theta, sections)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == p.shape[1:] + (hd // 2,)
        np.testing.assert_allclose(got.numpy(), want, atol=MROPE_ATOL * max(1, np.abs(want).max() / 40),
                                   rtol=0)
    # each band reads its section's stream
    got = rotary.mrope_angles(torch.from_numpy(pos), hd, theta, sections)
    inv = rotary.rope_freqs(hd, theta)
    bounds = np.cumsum((0,) + tuple(sections))
    for stream in range(3):
        lo, hi = bounds[stream], bounds[stream + 1]
        want = torch.from_numpy(pos[stream]).float()[:, None] * inv[lo:hi]
        assert torch.equal(got[:, lo:hi], want)


@pytest.mark.parametrize("sections", [(16, 24, 23), (16, 24, 25), (64, 0, 1)])
def test_mrope_sections_that_do_not_cover_the_head_raise_as_the_reference(sections):
    pos = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="must sum to head_dim//2 = 64"):
        rotary.mrope_angles(pos, 128, 1e6, sections)
    with pytest.raises(ValueError, match="must sum to head_dim//2 = 64"):
        ref_rotary.mrope_angles(jnp.zeros((3, 4), jnp.int32), 128, 1e6, sections)


@pytest.mark.parametrize("reduced", [False, True])
def test_mrope_on_text_positions_is_rope_element_for_element(reduced):
    """t = h = w: make_angles' M-RoPE equals rope_angles bit for bit, at
    qwen2-vl's head dim and the reduced one."""
    cfg = get_config(ARCH, reduced=reduced)
    positions = torch.arange(1000)
    got = mdl.make_angles(cfg, positions)
    want = rotary.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    assert cfg.mrope and torch.equal(got, want)
    text = mdl.make_angles(dataclasses.replace(cfg, mrope=False), positions)
    assert torch.equal(got, text)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def _clone(caches):
    return {"layers": [{k: v.clone() if torch.is_tensor(v) else v for k, v in layer.items()}
                       for layer in caches["layers"]], "pos": caches["pos"]}


@functools.cache
def _port_run(items=()):
    """The port's prefill (vision embeddings in the leading slots) into a
    cache of P + GEN and GEN - 1 decode steps fed the reference's tokens:
    (ref, cfg, hidden, logits, prefill caches, per-step logits, final
    caches)."""
    ref = reference_run(ARCH, items, B, P, GEN)
    cfg, params = port_params(ARCH, items)
    with torch.inference_mode():
        caches = mdl.init_cache(cfg, B, P + GEN, device="cpu")
        hidden, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long(),
                                        caches=caches, **torch_extras(cfg, B))
        logits = mdl.logits_from_hidden(cfg, params, hidden)
        prefill = _clone(caches)
        steps_ = [logits[:, -1]]
        for t in range(1, GEN):
            tok = torch.from_numpy(ref["tokens"][:, t - 1:t]).long()
            step, caches = mdl.decode_step(cfg, params, tok, caches)
            steps_.append(step)
    return ref, cfg, hidden, logits, prefill, torch.stack(steps_), caches


def test_forward_with_vision_embeds_matches_the_reference():
    ref, cfg, hidden, logits, _, _, _ = _port_run()
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=F32_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32_ATOL)


def test_vision_embeds_replace_the_leading_slots():
    """The first n_vision_tokens slots' token ids do not matter; the rest do."""
    cfg, params = port_params(ARCH)
    ex = torch_extras(cfg, B)
    toks = torch.from_numpy(reference_run(ARCH, (), B, P, GEN)["prompts"]).long()
    other = toks.clone()
    other[:, :cfg.n_vision_tokens] = (other[:, :cfg.n_vision_tokens] + 1) % cfg.vocab_size
    with torch.inference_mode():
        a = mdl.forward(cfg, params, toks, **ex)[0]
        b = mdl.forward(cfg, params, other, **ex)[0]
        other[:, -1] = (other[:, -1] + 1) % cfg.vocab_size
        c = mdl.forward(cfg, params, other, **ex)[0]
    assert torch.equal(a, b) and not torch.equal(a[:, -1], c[:, -1])


@pytest.mark.parametrize("items", [(), (("n_layers", 2),)], ids=["1 layer", "2 layers"])
def test_prefill_then_decode_matches_the_reference_at_every_step(items):
    ref = reference_run(ARCH, items, B, P, GEN)
    cfg, params = port_params(ARCH, items)
    tokens, steps_ = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                    device="cpu", **torch_extras(cfg, B))
    assert tuple(steps_.shape) == (GEN, B, cfg.vocab_size)
    np.testing.assert_allclose(steps_.numpy(), ref["steps"], atol=F32_ATOL)
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])


def test_caches_match_the_reference_after_prefill_and_decode():
    """The M-RoPE-rotated k and the v after the prefill and after the 5
    decode steps."""
    ref, cfg, _, _, prefill, steps_, final = _port_run()
    assert_caches_equal(cfg, prefill, ref["caches"])
    assert_caches_equal(cfg, final, ref["final_caches"])
    np.testing.assert_allclose(steps_.numpy(), ref["steps"], atol=F32_ATOL)


def test_decode_step_with_input_embed_matches_the_reference():
    """``decode_step(input_embed=)``: an embedding in place of the token,
    after the prefill, against the reference's, 3 steps."""
    ref_cfg, cfg = configs(ARCH)
    ref = reference_run(ARCH, (), B, P, GEN)
    _, _, _, _, prefill, _, _ = _port_run()
    caches = _clone(prefill)
    want_caches = jax.tree_util.tree_map(jnp.asarray, ref["caches"])
    _, params = port_params(ARCH)
    decode = jax.jit(lambda p, t, c, e: ref_model.decode_step(ref_cfg, p, t, c, input_embed=e))
    tok = np.zeros((B, 1), np.int32)
    for t in range(3):
        embed = np.random.default_rng(20 + t).normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        want, want_caches = decode(ref["params"], tok, want_caches, embed)
        with torch.inference_mode():
            got, caches = mdl.decode_step(cfg, params, torch.from_numpy(tok).long(), caches,
                                          input_embed=torch.from_numpy(embed))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    assert_caches_equal(cfg, caches, jax.tree_util.tree_map(np.asarray, want_caches))


def test_bf16_prefill_and_decode_match_the_reference_where_the_margin_decides():
    """bf16 logits to atol 0.1 (the port's prefill through the flash route's
    plain version, the reference's through ``attend``) and equal tokens
    wherever the reference's top-2 margin exceeds 0.2, step by step until a
    row's tokens part."""
    items = (("dtype", "bfloat16"),)
    ref = reference_run(ARCH, items, B, P, GEN)
    cfg, params = port_params(ARCH, items)
    tokens, steps_ = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                    device="cpu", **torch_extras(cfg, B, torch.bfloat16))
    assert steps_.dtype == torch.bfloat16
    got = steps_.float().numpy()
    held = 0
    for b in range(B):
        for t in range(GEN):
            np.testing.assert_allclose(got[t, b], ref["steps"][t, b], atol=BF16_ATOL)
            top2 = np.sort(ref["steps"][t, b])[-2:]
            if top2[1] - top2[0] > BF16_MARGIN:
                held += 1
                assert tokens[b, t].item() == ref["tokens"][b, t], (b, t)
            if tokens[b, t].item() != ref["tokens"][b, t]:
                break
    assert held >= B


@pytest.mark.parametrize("remat", [False, True], ids=["remat off", "remat on"])
def test_loss_and_every_gradient_leaf_match_the_reference(remat):
    """``loss_fn`` with vision embeddings: the leading slots' token
    embeddings get no gradient from them, the rest as the reference's."""
    assert_loss_and_grads_match(ARCH, remat=remat)


def test_a_train_step_with_vision_embeds_matches_the_reference():
    """``make_train_step`` with ``vision_embeds`` in the batch: the loss, CE
    and gradient norm against the reference's jitted step. (The parameters
    after one AdamW step carry each gradient entry's sign, lr · g / (|g| + ε);
    the gradient leaves themselves are held above.)"""
    ref_cfg, cfg = configs(ARCH)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    tgts = (toks + 1) % cfg.vocab_size
    vis = extras(cfg, B)["vision_embeds"]
    opt = ref_adamw(3e-3)
    tree = ref_params(ARCH)
    ref_state = {"params": tree, "opt_state": opt.init(tree), "step": jnp.zeros((), jnp.int32)}
    new, want = jax.jit(ref_steps.make_train_step(ref_cfg, opt))(
        ref_state, {"tokens": toks, "targets": tgts, "vision_embeds": vis})
    popt = adamw(3e-3)
    state = steps.init_train_state(mdl.params_from_numpy(cfg, tree, device="cpu"), popt)
    state, got = steps.make_train_step(cfg, popt)(state, {
        "tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgts).long(),
        "vision_embeds": torch.from_numpy(vis)})
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=2e-6, rtol=0)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)
    assert int(state["step"]) == int(new["step"]) == 1


def test_params_round_trip_key_for_key():
    got = assert_round_trip(ARCH)
    assert {"/stack/pos0/attn/bq", "/stack/pos0/attn/wq", "/embed"} <= got


def test_full_width_lm_holds_the_reference_count():
    """qwen2-vl-2b at full width on the meta device: 1,543,714,304
    parameters, qwen2-1.5b's backbone."""
    params = mdl.init_params(get_config(ARCH), device="meta")
    assert mdl.param_count(params) == 1_543_714_304
    assert params.encoder is None


# --------------------------------------------------------------------------
# the doors
# --------------------------------------------------------------------------
def test_serve_and_train_clis_run_qwen2_vl_on_the_cpu(capsys):
    """The CLIs feed the reference's zero vision stubs (4 slots reduced)."""
    serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "4", "--batch", "2",
                "--seq", "16", "--log-every", "3"])
    out = capsys.readouterr().out
    assert "prefill (2x9)" in out and "decoded 2 x 2 tokens" in out
    assert "step     0 loss" in out and "step     3 loss" in out


def test_frontend_stubs_are_the_references_zeros():
    _, cfg = configs(ARCH)
    stubs = steps.frontend_stubs(cfg, 3, "cpu")
    assert list(stubs) == ["vision_embeds"]
    assert tuple(stubs["vision_embeds"].shape) == (3, cfg.n_vision_tokens, cfg.d_model)
    assert not stubs["vision_embeds"].any()
    assert steps.frontend_stubs(get_config("qwen2-1.5b", reduced=True), 3, "cpu") == {}


def test_zero_vision_stubs_blow_up_the_gradient_as_in_the_reference():
    """Under the zero stubs the leading rows stay exactly zero through every
    layer; rmsnorm's Jacobian at a zero row is 1/√ε, and the gradient grows
    ~10³ a layer in both packages alike (ROADMAP, "Known state"): at 4 layers
    the largest entry is ~1e10 against ~0.2 for text alone, and the port's
    gradients equal the reference's to 1e-4 of that scale."""
    ref_cfg, cfg = configs(ARCH, n_layers=4)
    tree = jax.tree_util.tree_map(np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tgts = (toks + 1) % cfg.vocab_size
    zeros = np.zeros((2, cfg.n_vision_tokens, cfg.d_model), np.float32)
    want = jax.tree_util.tree_leaves(jax.jit(jax.grad(
        lambda p: ref_model.loss_fn(ref_cfg, p, toks, tgts, vision_embeds=zeros)[0]))(tree))
    params = mdl.params_from_numpy(cfg, tree, device="cpu").requires_grad_(True)
    loss, _ = mdl.loss_fn(cfg, params, torch.from_numpy(toks).long(), torch.from_numpy(tgts).long(),
                          vision_embeds=torch.from_numpy(zeros))
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    got = jax.tree_util.tree_leaves(mdl.reference_tree(params, grads))
    scale = max(float(np.abs(w).max()) for w in want)
    assert scale > 1e9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4 * scale, rtol=0)
    text = jax.tree_util.tree_leaves(jax.jit(jax.grad(
        lambda p: ref_model.loss_fn(ref_cfg, p, toks, tgts)[0]))(tree))
    assert max(float(np.abs(w).max()) for w in text) < 1.0
