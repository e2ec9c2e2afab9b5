"""Shared reference runs for the parity tests of the recurrent models
(``test_torch_rglru.py``, ``test_torch_xlstm.py``) and of the models with
a front end (``test_torch_whisper.py``, ``test_torch_qwen2_vl.py``).

The reference's random parameters of a reduced config, every bias and
norm scale moved off its init value by numpy noise, the same numpy
prompts and tokens for both packages, and for a model with a front end the
same random numpy front-end outputs (:func:`extras`: whisper's frames,
qwen2-vl's vision embeddings) in every prefill and loss; one jitted JAX
prefill, decode and ``value_and_grad`` per config, cached for the test
process.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.models import model as ref_model
from repro_torch.configs import get_config
from repro_torch.models import model as mdl

F32_ATOL = 2e-5
# caches and recurrent states: F32_ATOL plus 1e-5 relative, for the sLSTM's
# normalizer n, a running sum of exp'd gates (to 9 after 24 steps), whose
# last bits follow the order the recurrent products sum in
STATE_RTOL = 1e-5
BF16_ATOL = 0.1
LOSS_ATOL = 2e-6
GRAD_ATOL, GRAD_RTOL = 2e-6, 1e-4


def configs(arch, **overrides):
    return (dataclasses.replace(ref_get_config(arch, reduced=True), **overrides),
            dataclasses.replace(get_config(arch, reduced=True), **overrides))


def nudge(rng):
    def move(path, a):  # biases and norm scales start at 0, 1 or 3: move them
        key = jax.tree_util.keystr(path)
        if any(s in key for s in ("'b", "conv_b", "scale", "_norm")):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    return move


def torch_tree(tree, dtype=torch.float32):
    return {k: torch_tree(v, dtype) if isinstance(v, dict) else torch.tensor(np.asarray(v), dtype=dtype)
            for k, v in tree.items()}


def extras(cfg, b, seed=3) -> dict:
    """Random front-end outputs of ``cfg`` for a batch of ``b`` (numpy f32):
    ``frames`` (b, n_frames, d_model) for an audio model, ``vision_embeds``
    (b, n_vision_tokens, d_model) for a VLM; empty for a text model."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.normal(size=(b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision":
        return {"vision_embeds": rng.normal(size=(b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    return {}


def torch_extras(cfg, b, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(v).to(dtype) for k, v in extras(cfg, b).items()}


@functools.cache
def ref_params(arch, items=()):
    cfg, _ = configs(arch, **dict(items))
    params = jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    return jax.tree_util.tree_map_with_path(nudge(np.random.default_rng(1)), params)


@functools.cache
def reference_run(arch, items=(), b=2, p=19, gen=6):
    """Prefill of ``p`` random tokens (and :func:`extras`) into a cache of
    ``p + gen``, then ``gen - 1`` greedy decode steps: params, prompts,
    hidden, logits, tokens, per-step logits and the prefill's caches, as
    numpy."""
    cfg, _ = configs(arch, **dict(items))
    params = ref_params(arch, items)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (b, p)).astype(np.int32)

    @jax.jit
    def prefill(params, tokens, ex):
        caches = ref_model.init_cache(cfg, b, p + gen)
        hidden, caches, _ = ref_model.forward(cfg, params, tokens, caches=caches, **ex)
        return hidden, ref_model.logits_from_hidden(cfg, params, hidden), caches

    decode = jax.jit(lambda params, tok, caches: ref_model.decode_step(cfg, params, tok, caches))
    hidden, logits, caches = prefill(params, prompts, extras(cfg, b))
    prefill_caches = jax.tree_util.tree_map(np.asarray, caches)
    step = logits[:, -1]
    toks, steps = [], []
    for t in range(gen):
        if t:
            step, caches = decode(params, tok, caches)
        steps.append(np.asarray(step, np.float32))
        tok = jnp.argmax(step, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    return dict(params=params, prompts=prompts, hidden=np.asarray(hidden, np.float32),
                logits=np.asarray(logits, np.float32), tokens=np.concatenate(toks, axis=1),
                steps=np.stack(steps), caches=prefill_caches,
                final_caches=jax.tree_util.tree_map(np.asarray, caches))


def port_params(arch, items=()):
    _, cfg = configs(arch, **dict(items))
    return cfg, mdl.params_from_numpy(cfg, ref_params(arch, items), device="cpu")


def reference_layer_caches(cfg, caches) -> list:
    """The reference's cache tree -> one dict per layer in the port's order
    (first blocks, the stack's repeats, the tail)."""
    period = len(cfg.pattern)
    layers = list(caches["first"])
    for r in range(cfg.n_repeats):
        layers += [{k: v[r] for k, v in caches["stack"][f"pos{i}"].items()} for i in range(period)]
    return layers + list(caches["tail"])


def assert_caches_equal(cfg, got, want_tree, atol=F32_ATOL, rtol=STATE_RTOL):
    """Each layer's cache of the port against the reference's: the same
    keys, shapes and values; ``pos`` equal."""
    want = reference_layer_caches(cfg, want_tree)
    assert len(got["layers"]) == len(want) == cfg.n_layers
    assert got["pos"] == int(want_tree["pos"])
    for i, (layer, w) in enumerate(zip(got["layers"], want)):
        assert set(layer) == set(w), (i, set(layer), set(w))
        for key, a in w.items():
            if key == "pos":
                assert layer[key] == int(a), (i, key)
                continue
            g = layer[key]
            assert tuple(g.shape) == a.shape, (i, key, tuple(g.shape), a.shape)
            np.testing.assert_allclose(g.float().numpy(), np.asarray(a, np.float32), atol=atol,
                                       rtol=rtol, err_msg=f"layer {i} {key}")


def tokens(vocab, b=2, s=24, seed=2):
    batch = RefTokenPipeline(vocab, b, s, seed=seed).next_batch()
    return batch.tokens, batch.targets


@functools.cache
def ref_value_and_grad(arch, items=()):
    cfg, _ = configs(arch, **dict(items))
    toks, tgts = tokens(cfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(lambda p, t, g, ex: ref_model.loss_fn(cfg, p, t, g, **ex),
                                    has_aux=True))
    (loss, metrics), grads = fn(ref_params(arch, items), toks, tgts, extras(cfg, toks.shape[0]))
    return float(loss), float(metrics["ce"]), jax.tree_util.tree_map(np.asarray, grads)


def assert_loss_and_grads_match(arch, items=(), *, remat=False):
    """Loss and every gradient leaf of the port's ``loss_fn`` (with
    ``cfg.remat`` as given) against the reference's ``jax.value_and_grad``
    of the same function (its remat recomputes the same values), from the
    same parameters and front-end outputs."""
    want_loss, want_ce, want = ref_value_and_grad(arch, items)
    cfg, params = port_params(arch, items)
    cfg = dataclasses.replace(cfg, remat=remat)
    params.requires_grad_(True)
    toks, tgts = tokens(cfg.vocab_size)
    loss, metrics = mdl.loss_fn(cfg, params, torch.from_numpy(toks), torch.from_numpy(tgts),
                                **torch_extras(cfg, toks.shape[0]))
    names, leaves = zip(*params.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), want_loss, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(metrics["ce"].detach()), want_ce, atol=LOSS_ATOL, rtol=0)
    got = mdl.reference_tree(params, grads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert np.isfinite(g).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))
    return grads


def keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key in tree for k in keys(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, tuple):
        return [k for i, t in enumerate(tree) for k in keys(t, f"{prefix}/{i}")]
    return [prefix]


def assert_round_trip(arch, items=()):
    """params_to_numpy, flatten_lm and lm_views against the reference's tree,
    key for key and bit for bit; returns the reference tree's keys."""
    cfg, params = port_params(arch, items)
    want_tree = ref_params(arch, items)
    back = mdl.params_to_numpy(cfg, params)
    assert sorted(keys(back)) == sorted(keys(want_tree))
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_array_equal(got, want)
    flat = mdl.flatten_lm(params)
    want_flat = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(want_tree)])
    np.testing.assert_array_equal(flat.numpy(), want_flat)
    views = mdl.lm_views(flat, params)
    assert [n for n, _ in views.named_parameters()] == [n for n, _ in params.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(views.parameters(), params.parameters()))
    return set(keys(back))
