"""The port's Multi-head Latent Attention (``models/layers/mla.py``) and the
deepseek-v2-lite serve path against the JAX package's.

The reduced deepseek-v2-lite-16b (MLA with kv_lora_rank 32, rope / nope /
v head dims 16 / 32 / 32; a dense first block, then ``("mla", "moe")``
blocks) with the reference's random parameters, every norm scale moved
off 1 by numpy noise, carried across with ``params_from_numpy``; the same
numpy inputs go through both. Tolerances: f32 as the dense model's tests,
atol 2e-5 on outputs, hidden states and logits (the two sum in other
orders) and greedy tokens equal; absorbed decode against naive within
2e-5 in f32 (the same function, its products in another order); bf16
logits within 0.1, the dense model's bf16 limit (both round the scores to
bf16 at the same places, the products at others).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import model as ref_model
from repro.models.layers import mla as ref_mla
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as mdl
from repro_torch.models.layers import mla
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "deepseek-v2-lite-16b"
F32_ATOL = 2e-5
BF16_ATOL = 0.1
ABSORBED_ATOL = 2e-5
B, P, GEN = 2, 19, 6


def _configs(**overrides):
    ref, port = ref_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    mode = overrides.pop("decode_mode", None)
    if mode is not None:
        ref = dataclasses.replace(ref, mla=dataclasses.replace(ref.mla, decode_mode=mode))
        port = dataclasses.replace(port, mla=dataclasses.replace(port.mla, decode_mode=mode))
    return dataclasses.replace(ref, **overrides), dataclasses.replace(port, **overrides)


def _nudge(rng):
    def nudge(path, a):  # norm scales start at 1: move them
        key = jax.tree_util.keystr(path)
        if "scale" in key or "_norm" in key:
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    return nudge


def _torch_tree(tree, dtype=torch.float32):
    return {k: _torch_tree(v, dtype) if isinstance(v, dict) else torch.tensor(np.asarray(v), dtype=dtype)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------
S, CACHE = 11, 16


@functools.cache
def _layer(dtype="float32"):
    """The reference layer's params, input, full pass, and 3 decode steps of
    each mode from the full pass's cache."""
    ref_cfg, _ = _configs(dtype=dtype)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, ref_mla.init_mla(ref_cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map_with_path(_nudge(rng), params)
    x = rng.normal(size=(B, S + 3, ref_cfg.d_model)).astype(np.float32)
    dt = jnp.dtype(dtype)
    angles = ref_model.make_angles(ref_cfg, jnp.arange(S + 3))
    y, seed = jax.jit(functools.partial(ref_mla.mla_full, ref_cfg))(
        params, jnp.asarray(x[:, :S], dt), angles[:S])
    out = {"params": params, "x": x, "y": np.asarray(y, np.float32),
           "c": np.asarray(seed["c"], np.float32), "k_rope": np.asarray(seed["k_rope"], np.float32)}
    for mode in ("naive", "absorbed"):
        cfg_m = dataclasses.replace(ref_cfg, mla=dataclasses.replace(ref_cfg.mla, decode_mode=mode))
        cache = ref_mla.init_mla_cache(cfg_m, B, CACHE, dt)
        cache = {"c": cache["c"].at[:, :S].set(seed["c"]),
                 "k_rope": cache["k_rope"].at[:, :S].set(seed["k_rope"]),
                 "pos": jnp.asarray(S, jnp.int32)}
        decode = jax.jit(functools.partial(ref_mla.mla_decode, cfg_m))
        ys = []
        for t in range(3):
            yt, cache = decode(params, jnp.asarray(x[:, S + t:S + t + 1], dt),
                               angles[S + t:S + t + 1], cache)
            ys.append(np.asarray(yt, np.float32))
        out[mode] = (np.concatenate(ys, axis=1), np.asarray(cache["c"], np.float32),
                     np.asarray(cache["k_rope"], np.float32), int(cache["pos"]))
    return out


def _port_layer(dtype="float32", mode="naive"):
    ref = _layer(dtype)
    _, cfg = _configs(dtype=dtype, decode_mode=mode)
    tdt = getattr(torch, dtype)
    params = _torch_tree(ref["params"])
    x = torch.from_numpy(ref["x"]).to(tdt)
    angles = mdl.make_angles(cfg, torch.arange(S + 3))
    y, seed = mla.mla_full(cfg, params, x[:, :S], angles[:S])
    cache = mla.init_mla_cache(cfg, B, CACHE, tdt, "cpu")
    cache["c"][:, :S], cache["k_rope"][:, :S], cache["pos"] = seed["c"], seed["k_rope"], S
    ys = []
    for t in range(3):
        yt, cache = mla.mla_decode(cfg, params, x[:, S + t:S + t + 1], angles[S + t:S + t + 1], cache)
        ys.append(yt)
    return ref, y, seed, torch.cat(ys, dim=1), cache


def test_make_angles_rotates_mla_rope_dims_only():
    for reduced in (False, True):
        ref_cfg, cfg = ref_get_config(ARCH, reduced=reduced), get_config(ARCH, reduced=reduced)
        got = mdl.make_angles(cfg, torch.arange(7))
        assert tuple(got.shape) == (7, cfg.mla.rope_head_dim // 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_model.make_angles(ref_cfg, jnp.arange(7))),
                                   rtol=1e-6)


def test_mla_full_matches_reference():
    ref, y, seed, _, _ = _port_layer()
    assert y.dtype == torch.float32 and tuple(y.shape) == ref["y"].shape
    np.testing.assert_allclose(y.numpy(), ref["y"], atol=F32_ATOL)
    np.testing.assert_allclose(seed["c"].numpy(), ref["c"], atol=F32_ATOL)
    np.testing.assert_allclose(seed["k_rope"].numpy(), ref["k_rope"], atol=F32_ATOL)


@pytest.mark.parametrize("mode", ["naive", "absorbed"])
def test_mla_decode_matches_reference(mode):
    ref, _, _, ys, cache = _port_layer(mode=mode)
    want_y, want_c, want_kr, want_pos = ref[mode]
    np.testing.assert_allclose(ys.numpy(), want_y, atol=F32_ATOL)
    np.testing.assert_allclose(cache["c"].numpy(), want_c, atol=F32_ATOL)
    np.testing.assert_allclose(cache["k_rope"].numpy(), want_kr, atol=F32_ATOL)
    assert cache["pos"] == want_pos == S + 3 and isinstance(cache["pos"], int)


def test_absorbed_decode_equals_naive():
    _, _, _, naive, _ = _port_layer(mode="naive")
    _, _, _, absorbed, _ = _port_layer(mode="absorbed")
    assert float((naive - absorbed).abs().max()) > 0  # two products, not one path
    torch.testing.assert_close(absorbed, naive, atol=ABSORBED_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["naive", "absorbed"])
def test_bf16_layer_matches_reference_under_the_bf16_limit(mode):
    ref, y, _, ys, _ = _port_layer("bfloat16", mode)
    assert y.dtype == ys.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), ref["y"], atol=BF16_ATOL)
    np.testing.assert_allclose(ys.float().numpy(), ref[mode][0], atol=BF16_ATOL)


# --------------------------------------------------------------------------
# the model: reduced deepseek-v2-lite
# --------------------------------------------------------------------------
CASES = {
    "2 layers": {"n_layers": 2},
    "3 layers": {"n_layers": 3},  # a stack of two repeats
    "2 layers, absorbed": {"n_layers": 2, "decode_mode": "absorbed"},
}


@functools.cache
def _reference(items):
    overrides = dict(items)
    cfg, _ = _configs(**overrides)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map_with_path(_nudge(rng), params)
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)

    @jax.jit
    def prefill(params, tokens):
        caches = ref_model.init_cache(cfg, B, P + GEN)
        hidden, caches, _ = ref_model.forward(cfg, params, tokens, caches=caches)
        return hidden, ref_model.logits_from_hidden(cfg, params, hidden), caches

    decode = jax.jit(lambda params, tok, caches: ref_model.decode_step(cfg, params, tok, caches))
    hidden, logits, caches = prefill(params, prompts)
    prefill_caches = jax.tree_util.tree_map(np.asarray, caches)
    step = logits[:, -1]
    toks, steps = [], []
    for t in range(GEN):
        if t:
            step, caches = decode(params, tok, caches)
        steps.append(np.asarray(step, np.float32))
        tok = jnp.argmax(step, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return dict(params=params, prompts=prompts, hidden=np.asarray(hidden, np.float32),
                logits=np.asarray(logits, np.float32), tokens=np.concatenate(toks, axis=1),
                steps=np.stack(steps), caches=prefill_caches)


def _port(**overrides):
    ref = _reference(tuple(sorted(overrides.items())))
    _, cfg = _configs(**overrides)
    return ref, cfg, mdl.params_from_numpy(cfg, ref["params"], device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case):
    ref, cfg, params = _port(**CASES[case])
    with torch.inference_mode():
        hidden, caches, aux = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long())
        logits = mdl.logits_from_hidden(cfg, params, hidden)
    assert caches is None and float(aux) > 0
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=F32_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_matches_reference_at_every_step(case):
    ref, cfg, params = _port(**CASES[case])
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    assert tuple(steps.shape) == (GEN, B, cfg.vocab_size)
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=F32_ATOL)
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])


def test_prefill_seeds_the_cache_like_the_reference():
    """After a prefill of P into a cache of P + GEN, each layer holds the
    reference's latent and rotary key at [0, P), zeros after, and pos P."""
    ref, cfg, params = _port(**CASES["3 layers"])
    caches = mdl.init_cache(cfg, B, P + GEN, device="cpu")
    with torch.inference_mode():
        _, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long(), caches=caches)
    assert caches["pos"] == P
    want = [ref["caches"]["first"][0]] + [
        {k: v[r] for k, v in ref["caches"]["stack"]["pos0"].items()} for r in range(2)]
    for layer, w in zip(caches["layers"], want):
        assert set(layer) == {"c", "k_rope", "pos"} and layer["pos"] == int(w["pos"]) == P
        for key in ("c", "k_rope"):
            assert tuple(layer[key].shape) == w[key].shape
            np.testing.assert_allclose(layer[key].numpy(), w[key], atol=F32_ATOL)
            assert not bool(layer[key][:, P:].any())


def test_bf16_prefill_and_decode_match_reference():
    ref, cfg, params = _port(n_layers=2, dtype="bfloat16")
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    assert steps.dtype == torch.bfloat16
    np.testing.assert_allclose(steps.float().numpy(), ref["steps"], atol=BF16_ATOL)
    assert np.array_equal(tokens[:, 0].numpy(), ref["tokens"][:, 0])


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key in tree for k in _keys(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, tuple):
        return [k for i, t in enumerate(tree) for k in _keys(t, f"{prefix}/{i}")]
    return [prefix]


def test_params_round_trip_key_for_key():
    ref, cfg, params = _port(**CASES["3 layers"])
    back = mdl.params_to_numpy(cfg, params)
    assert sorted(_keys(back)) == sorted(_keys(ref["params"]))
    assert {"/first/0/attn/kv_norm/scale", "/stack/pos0/attn/w_uk", "/first/0/mlp/w_gate",
            "/stack/pos0/moe/shared/w_down"} <= set(_keys(back))
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_array_equal(got, want)
    flat = mdl.flatten_lm(params)
    want_flat = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(ref["params"])])
    np.testing.assert_array_equal(flat.numpy(), want_flat)
    views = mdl.lm_views(flat, params)
    assert [n for n, _ in views.named_parameters()] == [n for n, _ in params.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(views.parameters(), params.parameters()))


def test_full_width_parameter_count_on_meta_equals_the_reference():
    cfg = get_config(ARCH)
    params = mdl.init_params(cfg, device="meta")
    shapes = jax.eval_shape(lambda k: ref_model.init_params(ref_get_config(ARCH), k),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert mdl.param_count(params) == want == 15_706_484_224
    attn = params.blocks[1]["attn"]
    assert tuple(attn["wq"].shape) == (2048, 16 * 192)
    assert tuple(attn["w_uv"].shape) == (512, 16, 128)
    assert tuple(params.blocks[0]["mlp"]["w_up"].shape) == (2048, 10944)
    assert tuple(params.blocks[1]["moe"]["shared"]["w_up"].shape) == (2048, 1408 * 2)


def test_init_params_is_seeded_and_serves_on_the_cpu():
    _, cfg = _configs()
    a, b = (mdl.init_params(cfg, 3, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert torch.equal(a.blocks[0]["attn"]["kv_norm"]["scale"], torch.ones(cfg.mla.kv_lora_rank))
    tokens, steps = serve.generate(cfg, a, torch.zeros((2, 7), dtype=torch.long), 3, device="cpu")
    assert tuple(tokens.shape) == (2, 3) and bool(torch.isfinite(steps).all())


def test_serve_cli_serves_deepseek_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill (2x9)" in out and "decoded 2 x 2 tokens" in out


def test_serve_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced"])
    _, cfg = _configs()
    params = mdl.init_params(cfg, device="cpu")
    for fn in (lambda: mdl.init_params(cfg), lambda: mdl.init_cache(cfg, 1, 4),
               lambda: serve.generate(cfg, params, torch.zeros((1, 3), dtype=torch.long), 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
