"""The port's whisper-small (the encoder, cross-attention, sinusoidal
positions) against the JAX package's.

The reduced whisper-small (2 ``("bidir", "mlp")`` encoder blocks over 16
frames, one decoder block with cross-attention; d_model 128, 4 heads with 4
kv heads of 32, QKV biases, gelu, tied head) with the reference's random
parameters, every bias and norm scale moved off its init value, carried
across with ``params_from_numpy``; the same random numpy frames and
tokens go through both (``tests/_torch_recurrent.py``).

Tolerances: f32 layers, encoder states, hidden states, logits and caches to
atol 2e-5 (the GEMMs sum in other orders), the caches also to 1e-5
relative (the shared limit); greedy tokens equal; bf16 logits to atol 0.1
(the dense model's bf16 limit) with tokens equal wherever the reference's
top-2 margin exceeds 0.2; the loss to 2e-6 and every gradient leaf,
the encoder's included, to atol 2e-6 + rtol 1e-4 (the dense trainer's);
flat vectors and the train-state bundle bit for bit. The sinusoidal
encodings agree to atol 2e-5 at the positions the tests run (below 64);
over whisper's 1,500 frames they differ by up to p · 2⁻²³ at position p
(measured 1.22e-4 at d 768): XLA's f32 ``exp`` is not correctly rounded in
41 of the 384 frequencies, torch's in 10, and a frequency's last bit moves
the angle p·f by p ulps of f.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_recurrent import (BF16_ATOL, F32_ATOL, assert_caches_equal, assert_loss_and_grads_match,
                              assert_round_trip, configs, extras, port_params, ref_params,
                              reference_run, torch_extras)

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.core import ClientPopulation as RefPopulation
from repro.launch import fl_train as ref_fl
from repro.models import blocks as ref_blocks
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro_torch.core import ClientPopulation
from repro_torch.launch import fl_train, serve, steps, train
from repro_torch.models import blocks as blk
from repro_torch.models import model as mdl
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "whisper-small"
B, P, GEN = 2, 19, 6
BF16_MARGIN = 0.2
DECODER = ("attn", "mlp")


def _x(shape, seed=5):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=F32_ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


# --------------------------------------------------------------------------
# positions, the encoder, cross-attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [768, 128])
def test_sinusoidal_matches_the_reference(d):
    """[sin | cos] concatenated, f32; equal to atol 2e-5 below position 64,
    and within p · 2⁻²³ at every position p of whisper's 1,500 frames."""
    want = np.asarray(ref_model.sinusoidal(jnp.arange(1500), d))
    got = mdl.sinusoidal(torch.arange(1500), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1500, d)
    np.testing.assert_allclose(got[:64].numpy(), want[:64], atol=F32_ATOL, rtol=0)
    err = np.abs(got.numpy() - want).max(axis=1)
    assert (err <= np.maximum(np.arange(1500), 1) * 2.0**-23 + 1e-7).all(), err.max()
    np.testing.assert_array_equal(got[0].numpy(), np.r_[np.zeros(d // 2), np.ones(d // 2)])


def test_encode_matches_the_reference():
    ref_cfg, _ = configs(ARCH)
    cfg, params = port_params(ARCH)
    frames = extras(cfg, B)["frames"]
    want = jax.jit(lambda p, f: ref_model.encode(ref_cfg, p, f))(ref_params(ARCH), frames)
    got = mdl.encode(cfg, params, torch.from_numpy(frames))
    assert tuple(got.shape) == (B, cfg.encoder.n_frames, cfg.d_model)
    _close(got, want)


def _ref_layer(i=0):
    """The reference's decoder block ``i`` (a slice of its stack)."""
    return jax.tree_util.tree_map(lambda a: a[i], ref_params(ARCH)["stack"]["pos0"])


def test_cross_kv_matches_the_reference():
    ref_cfg, cfg = configs(ARCH)
    _, params = port_params(ARCH)
    enc = _x((B, 16, cfg.d_model), seed=6)
    want_k, want_v = ref_blocks.cross_kv(ref_cfg, _ref_layer()["cross"], jnp.asarray(enc))
    got_k, got_v = blk.cross_kv(cfg, params.blocks[0]["cross"], torch.from_numpy(enc))
    assert tuple(got_k.shape) == (B, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    _close(got_k, want_k)
    _close(got_v, want_v)


def test_block_apply_with_cross_attention_matches_the_reference_in_both_modes():
    """A prefill of 7 tokens into a cache of 10 writes the encoder's k / v
    into ``ck`` / ``cv`` beside the self-attention's k / v; 3 decode steps
    read them and keep them."""
    ref_cfg, cfg = configs(ARCH)
    _, params = port_params(ARCH)
    f, s, length = cfg.encoder.n_frames, 7, 10
    enc, x = _x((B, f, cfg.d_model), seed=6), _x((B, s + 3, cfg.d_model), seed=7)
    layer = _ref_layer()
    apply = jax.jit(lambda p, x, c, e, mode: ref_blocks.block_apply(
        ref_cfg, DECODER, p, x, angles=None, mode=mode, cache=c, enc_out=e), static_argnums=4)
    want_cache = ref_blocks.init_block_cache(ref_cfg, DECODER, B, length, jnp.float32, cross_len=f)
    cache = blk.init_block_cache(cfg, DECODER, B, length, torch.float32, "cpu", cross_len=f)
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "pos"} == {
        k: v.shape for k, v in want_cache.items() if k != "pos"}
    want_y, want_cache, _ = apply(layer, jnp.asarray(x[:, :s]), want_cache, jnp.asarray(enc), "full")
    with torch.inference_mode():
        y, cache, aux = blk.block_apply(cfg, DECODER, params.blocks[0], torch.from_numpy(x[:, :s]),
                                        angles=None, mode="full", cache=cache,
                                        enc_out=torch.from_numpy(enc))
    assert aux is None and set(cache) == {"k", "v", "pos", "ck", "cv"} and cache["pos"] == s
    _close(y, want_y)
    for key in ("k", "v", "ck", "cv"):
        _close(cache[key], want_cache[key])
    for t in range(s, s + 3):
        want_y, want_cache, _ = apply(layer, jnp.asarray(x[:, t:t + 1]), want_cache, None, "decode")
        with torch.inference_mode():
            y, cache, _ = blk.block_apply(cfg, DECODER, params.blocks[0],
                                          torch.from_numpy(x[:, t:t + 1]), angles=None,
                                          mode="decode", cache=cache)
        assert set(cache) == {"k", "v", "pos", "ck", "cv"} and cache["pos"] == t + 1
        _close(y, want_y)
        for key in ("k", "v", "ck", "cv"):
            _close(cache[key], want_cache[key])


def test_the_encoder_block_is_bidirectional_and_unrotated():
    """An encoder block sees later frames (a causal block would not), and
    make_angles gives whisper none."""
    _, cfg = configs(ARCH)
    _, params = port_params(ARCH)
    x = torch.from_numpy(_x((1, 8, cfg.d_model), seed=8))
    block = params.encoder.blocks[0]
    with torch.inference_mode():
        y = blk.block_apply(cfg, blk.ENCODER, block, x, angles=None, mode="full")[0]
        x2 = x.clone()
        x2[:, -1] += 1.0
        y2 = blk.block_apply(cfg, blk.ENCODER, block, x2, angles=None, mode="full")[0]
    assert not torch.allclose(y[:, 0], y2[:, 0])
    assert mdl.make_angles(cfg, torch.arange(4)) is None
    assert blk.ENCODER not in blk.PORTED


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def _clone(caches):
    return {"layers": [{k: v.clone() if torch.is_tensor(v) else v for k, v in layer.items()}
                       for layer in caches["layers"]], "pos": caches["pos"]}


@functools.cache
def _port_run(items=()):
    """The port's prefill (with the shared frames) into a cache of P + GEN
    and GEN - 1 decode steps fed the reference's tokens: (ref, cfg, hidden,
    logits, prefill caches, per-step logits, final caches)."""
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


def test_forward_with_frames_matches_the_reference():
    ref, _, hidden, logits, _, _, _ = _port_run()
    _close(hidden, ref["hidden"])
    _close(logits, ref["logits"])


@pytest.mark.parametrize("items", [(), (("n_layers", 2),)], ids=["1 layer", "2 layers"])
def test_prefill_then_decode_matches_the_reference_at_every_step(items):
    """The reduced config's one decoder layer, and two (the stack's leading
    axis, each layer's cross-attention on the same encoder states)."""
    ref = reference_run(ARCH, items, B, P, GEN)
    cfg, params = port_params(ARCH, items)
    tokens, steps_ = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                    device="cpu", **torch_extras(cfg, B))
    assert tuple(steps_.shape) == (GEN, B, cfg.vocab_size)
    _close(steps_, ref["steps"])
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])


def test_caches_hold_ck_and_cv_after_prefill_and_decode():
    """The decoder layer's self-attention k / v and cross-attention ck /
    cv (B, 16 frames, 4, 32) against the reference's after the prefill and
    after the 5 decode steps."""
    ref, cfg, _, _, prefill, steps_, final = _port_run()
    assert all(set(c) == {"k", "v", "pos", "ck", "cv"} for c in prefill["layers"] + final["layers"])
    assert tuple(prefill["layers"][0]["ck"].shape) == (B, cfg.encoder.n_frames, 4, 32)
    assert_caches_equal(cfg, prefill, ref["caches"])
    assert_caches_equal(cfg, final, ref["final_caches"])
    _close(steps_, ref["steps"])


def test_bf16_prefill_and_decode_match_the_reference_where_the_margin_decides():
    """bf16 logits to atol 0.1 and equal tokens wherever the reference's
    top-2 margin exceeds 0.2, step by step until a row's tokens part."""
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
    """``loss_fn`` with frames; the encoder's and cross-attention's leaves
    get gradients, as the decoder's do."""
    grads = assert_loss_and_grads_match(ARCH, remat=remat)
    for part in ("encoder.blocks.0.attn.wq", "encoder.blocks.1.mlp.w_up", "encoder.final_norm.scale",
                 "blocks.0.cross.wk", "blocks.0.cross.bv", "blocks.0.cross_norm.scale"):
        assert float(grads[part].abs().max()) > 0, part


def test_reference_leaves_follow_the_references_tree_order():
    """The encoder's leaves sit between ``embed`` and ``final_norm``, as the
    reference's key sort puts them; flat vectors bit for bit."""
    cfg, params = port_params(ARCH)
    got = ["/".join(path) for path, _ in mdl.reference_leaves(params)]
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(ref_params(ARCH))]
    assert got == want
    assert got[:3] == ["embed", "encoder/final_norm/scale", "encoder/stack/pos0/attn/bk"]
    assert got.index("final_norm/scale") > max(i for i, p in enumerate(got) if p.startswith("encoder"))
    keys = assert_round_trip(ARCH)
    assert {"/encoder/stack/pos0/mlp/w_up", "/stack/pos0/cross/wq", "/stack/pos0/cross_norm/scale"} <= keys


def test_full_width_lm_holds_the_reference_count():
    """whisper-small at full width on the meta device: 294,766,848
    parameters, the encoder's 12 blocks among them."""
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    params = mdl.init_params(cfg, device="meta")
    assert mdl.param_count(params) == 294_766_848
    assert len(params.encoder.blocks) == cfg.encoder.n_layers == 12
    assert all("cross" in b and "cross_norm" in b for b in params.blocks)


def test_train_state_bundle_is_read_by_the_reference(tmp_path):
    """The trainer's bundle of reduced whisper (frames the zero stubs) holds
    the encoder's parameters and moments; the reference restores it against
    its own train state's structure, bit for bit."""
    path = str(tmp_path / "state.npz")
    train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                "--seq", "16", "--checkpoint", path])
    ref_cfg, cfg = configs(ARCH)
    opt = ref_adamw(3e-3)
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    ref_state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    restored, step, _ = ref_restore(path, ref_state)
    assert step == 2 and int(restored["step"]) == 2
    state, _ = train.train(cfg, steps=2, batch=2, seq=16, lr=3e-3, device="cpu", log=lambda s: None)
    want = steps.train_state_tree(state)
    assert "encoder" in want["params"] and "encoder" in want["opt_state"]["mu"]
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_a_train_step_with_frames_matches_the_reference():
    """``make_train_step`` with ``frames`` in the batch: the loss, CE and
    gradient norm against the reference's jitted step."""
    from repro.launch import steps as ref_steps

    ref_cfg, cfg = configs(ARCH)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, 12)).astype(np.int32)
    tgts = (toks + 1) % cfg.vocab_size
    frames = extras(cfg, B)["frames"]
    opt = ref_adamw(3e-3)
    tree = ref_params(ARCH)
    ref_state = {"params": tree, "opt_state": opt.init(tree), "step": jnp.zeros((), jnp.int32)}
    _, want = jax.jit(ref_steps.make_train_step(ref_cfg, opt))(
        ref_state, {"tokens": toks, "targets": tgts, "frames": frames})
    from repro_torch.optim import adamw

    popt = adamw(3e-3)
    state = steps.init_train_state(mdl.params_from_numpy(cfg, tree, device="cpu"), popt)
    _, got = steps.make_train_step(cfg, popt)(state, {
        "tokens": torch.from_numpy(toks).long(), "targets": torch.from_numpy(tgts).long(),
        "frames": torch.from_numpy(frames)})
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=2e-6, rtol=0)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-5)


# --------------------------------------------------------------------------
# the doors
# --------------------------------------------------------------------------
def test_serve_and_train_clis_run_whisper_on_the_cpu(capsys):
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
    assert list(stubs) == ["frames"] and tuple(stubs["frames"].shape) == (3, 16, cfg.d_model)
    assert stubs["frames"].dtype == torch.float32 and not stubs["frames"].any()


def test_the_federated_lm_raises_on_whisper_in_both_packages(monkeypatch):
    """The local step calls ``loss_fn`` without frames in both packages, so
    ``encode`` gets None and raises ``AttributeError`` (ROADMAP, "Known
    state"): the port mirrors the reference."""
    ref_cfg, cfg = configs(ARCH)
    monkeypatch.setattr(mdl, "init_params", lambda c, seed=0, *, device="cuda":
                        mdl.params_from_numpy(c, ref_params(ARCH), device=device))
    fl_kw = dict(n_clients=6, m=2, n_rounds=1, n_local_steps=1, local_batch=2, seq_len=8,
                 sampler="md")
    sizes = np.array([100, 200, 300, 400, 500, 600])
    d = mdl.param_count(mdl.init_params(cfg, device="cpu"))
    for pkg, pop, run_cfg, kw in ((ref_fl, RefPopulation(sizes), ref_cfg, {}),
                                  (fl_train, ClientPopulation(sizes), cfg, {"device": "cpu"})):
        fl = pkg.FLLMConfig(**fl_kw)
        with contextlib.closing(pkg.make_lm_sampler(fl, pop, update_dim=d, **kw)) as sm:
            with pytest.raises(AttributeError, match="'NoneType' object has no attribute"):
                pkg.run_federated_lm(run_cfg, fl, sm, **kw)

