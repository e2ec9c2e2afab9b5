"""The port's MoE feed-forward layer (``models/layers/moe.py``) and the
qwen2-moe model against the JAX package's, on the same numpy inputs.

The reference's routing (which expert each token chooses, and whether it
keeps its place in that expert's queue) is recomputed here from the
reference's own formula with ``jax.lax.top_k``; the port must make the
same choices and keep the same set. Tolerances, f32: layer outputs (scale
~1) within 1e-5, the aux loss within 1e-6, model logits within 1e-4 and
greedy tokens equal. bf16: routing from bf16 logits; the outputs agree
within 2⁻⁶ of the output scale (two bf16 ulps of it; the products round at
other places).
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
from repro.models.layers import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as mdl
from repro_torch.models.layers import moe
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "qwen2-moe-a2.7b"
OUT_ATOL = 1e-5
AUX_ATOL = 1e-6
LOGIT_ATOL = 1e-4
BF16_REL = 2.0**-6


def _configs(**moe_overrides):
    ref, port = ref_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    return (dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe_overrides)),
            dataclasses.replace(port, moe=dataclasses.replace(port.moe, **moe_overrides)))


def _ref_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.array, ref_moe.init_moe(cfg, jax.random.PRNGKey(seed)))


def _torch_tree(tree, dtype=torch.float32):
    return {k: _torch_tree(v, dtype) if isinstance(v, dict) else torch.tensor(v, dtype=dtype)
            for k, v in tree.items()}


def _ref_routing(cfg, params, x):
    """The reference's (expert, kept) per (group, token, choice), by its
    ``moe_ffn`` grouping and ``_route_group`` formula."""
    moe_cfg = cfg.moe
    b, s, d = x.shape
    flat = jnp.asarray(x).reshape(b * s, d)
    gs = min(moe_cfg.group_size, b * s)
    rem = (b * s) % gs
    if rem:
        flat = jnp.concatenate([flat, jnp.zeros((gs - rem, d), flat.dtype)])
    groups = flat.reshape(-1, gs, d)
    c = ref_moe.expert_capacity(moe_cfg)

    def one(xg):
        logits = (xg @ jnp.asarray(params["router"]).astype(xg.dtype)).astype(jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        _, idx = jax.lax.top_k(probs, moe_cfg.top_k)
        mask = jax.nn.one_hot(idx, moe_cfg.n_routed, dtype=jnp.float32).sum(1)
        pos = jnp.cumsum(mask, axis=0) - 1.0
        keep = jnp.take_along_axis(pos, idx, axis=-1) < c
        return idx, keep

    idx, keep = jax.vmap(one)(groups)
    return np.asarray(idx), np.asarray(keep)


def _compare_layer(ref_cfg, cfg, params, x, *, dtype=torch.float32):
    want, want_aux = ref_moe.moe_ffn(ref_cfg, params, jnp.asarray(x, dtype=jnp.dtype(ref_cfg.dtype)))
    tp = _torch_tree(params)
    xt = torch.tensor(x).to(dtype)
    got, aux = moe.moe_ffn(cfg, tp, xt)
    r = moe.route(cfg, tp, moe.token_groups(cfg, xt))
    idx, keep = _ref_routing(ref_cfg, params, np.asarray(jnp.asarray(x, dtype=jnp.dtype(ref_cfg.dtype))))
    np.testing.assert_array_equal(r.expert.numpy(), idx)
    np.testing.assert_array_equal(r.kept.numpy(), keep)
    assert got.dtype == dtype and tuple(got.shape) == x.shape
    return got.float().numpy(), np.asarray(want, np.float32), float(aux), float(want_aux), r


@pytest.mark.parametrize("cfg_name,want", [("qwen2-moe-a2.7b", 170), ("deepseek-v2-lite-16b", 240)])
def test_expert_capacity_equals_reference(cfg_name, want):
    for reduced in (False, True):
        ref, port = ref_get_config(cfg_name, reduced=reduced), get_config(cfg_name, reduced=reduced)
        assert moe.expert_capacity(port.moe) == ref_moe.expert_capacity(ref.moe)
    assert moe.expert_capacity(get_config(cfg_name).moe) == want
    assert moe.expert_capacity(get_config(cfg_name, reduced=True).moe) == 64


def test_skewed_router_drops_the_same_tokens():
    """Capacity cut to 16 of a 64-token group and a router pulled toward
    experts 0 and 1 (logits of scale ~3): their queues overflow, and the
    same tokens are dropped."""
    ref_cfg, cfg = _configs(capacity_factor=0.5)
    params = _ref_params(ref_cfg)
    rng = np.random.default_rng(0)
    u = rng.normal(size=ref_cfg.d_model)
    u /= np.linalg.norm(u)
    x = (rng.normal(size=(2, 64, ref_cfg.d_model)) + 2.0 * u).astype(np.float32)
    params["router"][:, :2] += (1.5 * u)[:, None].astype(np.float32)
    got, want, aux, want_aux, r = _compare_layer(ref_cfg, cfg, params, x)
    assert moe.expert_capacity(cfg.moe) == 16
    for g in range(r.expert.shape[0]):  # each expert keeps its first 16 tokens of a group
        routed = torch.bincount(r.expert[g].reshape(-1), minlength=4)
        kept = torch.bincount(r.expert[g][r.kept[g]], minlength=4)
        assert torch.equal(kept, routed.clamp(max=16))
        assert int(routed[:2].sum()) >= 96, f"group {g}: experts 0 and 1 take {routed.tolist()}"
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    assert abs(aux - want_aux) <= AUX_ATOL


@pytest.mark.parametrize("b,s", [(3, 50), (1, 130)], ids=["tail 22 of 64", "tail 2 of 64"])
def test_ragged_tail_group_matches_reference(b, s):
    ref_cfg, cfg = _configs()
    params = _ref_params(ref_cfg, seed=1)
    x = np.random.default_rng(1).normal(size=(b, s, ref_cfg.d_model)).astype(np.float32)
    got, want, aux, want_aux, r = _compare_layer(ref_cfg, cfg, params, x)
    assert r.expert.shape[0] == -(-b * s // 64)
    # the zero pad tokens tie at a uniform softmax: experts 0 and 1
    pad = r.expert.reshape(-1, cfg.moe.top_k)[b * s:]
    assert pad.numel() and bool((pad == torch.tensor([0, 1])).all())
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    assert abs(aux - want_aux) <= AUX_ATOL


def test_decode_group_of_four_tokens_matches_reference():
    ref_cfg, cfg = _configs()
    params = _ref_params(ref_cfg, seed=2)
    x = np.random.default_rng(2).normal(size=(4, 1, ref_cfg.d_model)).astype(np.float32)
    got, want, aux, want_aux, r = _compare_layer(ref_cfg, cfg, params, x)
    assert tuple(r.expert.shape) == (1, 4, cfg.moe.top_k) and bool(r.kept.all())
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    assert abs(aux - want_aux) <= AUX_ATOL


def test_tied_router_logits_go_to_the_lower_expert_index():
    """Experts 1, 2 and 3 share one router column, expert 0 its negation:
    a token on the column's side ties three ways and takes 1 and 2; one
    on the other side takes 0, then 1 of the tied three."""
    ref_cfg, cfg = _configs()
    params = _ref_params(ref_cfg, seed=3)
    col = params["router"][:, 1].copy()
    params["router"][:, 0] = -col
    params["router"][:, 1:] = col[:, None]
    x = np.random.default_rng(3).normal(size=(2, 40, ref_cfg.d_model)).astype(np.float32)
    got, want, aux, want_aux, r = _compare_layer(ref_cfg, cfg, params, x)
    side = torch.tensor(x.reshape(-1, ref_cfg.d_model) @ col > 0)
    expert = r.expert.reshape(-1, cfg.moe.top_k)[: side.numel()]
    assert bool((expert[side] == torch.tensor([1, 2])).all())
    assert bool((expert[~side] == torch.tensor([0, 1])).all())
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    assert abs(aux - want_aux) <= AUX_ATOL


def test_bf16_layer_matches_reference_under_the_bf16_limit():
    ref_cfg, cfg = _configs()
    ref_cfg = dataclasses.replace(ref_cfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = _ref_params(ref_cfg, seed=4)
    x = np.random.default_rng(4).normal(size=(2, 48, ref_cfg.d_model)).astype(np.float32)
    got, want, aux, want_aux, _ = _compare_layer(ref_cfg, cfg, params, x, dtype=torch.bfloat16)
    limit = BF16_REL * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= limit
    assert abs(aux - want_aux) <= AUX_ATOL


# --------------------------------------------------------------------------
# the model: reduced qwen2-moe with the reference's parameters carried across
# --------------------------------------------------------------------------
B, P, GEN = 2, 19, 5


def _model_configs(n_layers):
    ref, port = ref_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    return (dataclasses.replace(ref, n_layers=n_layers),
            dataclasses.replace(port, n_layers=n_layers))


@functools.cache
def _reference(n_layers):
    cfg, _ = _model_configs(n_layers)
    params = jax.tree_util.tree_map(np.asarray, ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def nudge(path, a):  # biases and norm scales start at 0 and 1: move them
        key = jax.tree_util.keystr(path)
        if any(s in key for s in ("'b", "scale", "_norm")):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(nudge, params)
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)

    @jax.jit
    def prefill(params, tokens):
        caches = ref_model.init_cache(cfg, B, P + GEN)
        hidden, caches, aux = ref_model.forward(cfg, params, tokens, caches=caches)
        return ref_model.logits_from_hidden(cfg, params, hidden), caches, aux

    decode = jax.jit(lambda params, tok, caches: ref_model.decode_step(cfg, params, tok, caches))
    logits, caches, aux = prefill(params, prompts)
    step = logits[:, -1]
    toks, steps = [], []
    for t in range(GEN):
        if t:
            step, caches = decode(params, tok, caches)
        steps.append(np.asarray(step, np.float32))
        tok = jnp.argmax(step, axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
    targets = np.roll(prompts, -1, axis=1)
    total, metrics = jax.jit(lambda p, t, g: ref_model.loss_fn(cfg, p, t, g))(params, prompts, targets)
    return dict(params=params, prompts=prompts, logits=np.asarray(logits, np.float32),
                aux=float(aux), tokens=np.concatenate(toks, axis=1), steps=np.stack(steps),
                targets=targets, total=float(total), ce=float(metrics["ce"]),
                loss_aux=float(metrics["aux"]))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_prefill_and_greedy_decode_match_reference(n_layers):
    ref = _reference(n_layers)
    _, cfg = _model_configs(n_layers)
    params = mdl.params_from_numpy(cfg, ref["params"], device="cpu")
    prompts = torch.from_numpy(ref["prompts"]).long()
    with torch.inference_mode():
        hidden, caches, aux = mdl.forward(cfg, params, prompts)
        logits = mdl.logits_from_hidden(cfg, params, hidden)
    assert caches is None
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=LOGIT_ATOL)
    assert abs(float(aux) - ref["aux"]) <= AUX_ATOL * n_layers
    tokens, steps = serve.generate(cfg, params, prompts, GEN, device="cpu")
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])


def test_loss_fn_ce_and_aux_equal_reference():
    ref = _reference(2)
    _, cfg = _model_configs(2)
    params = mdl.params_from_numpy(cfg, ref["params"], device="cpu")
    with torch.no_grad():
        total, metrics = mdl.loss_fn(cfg, params, torch.from_numpy(ref["prompts"]).long(),
                                     torch.from_numpy(ref["targets"]).long())
    assert ref["loss_aux"] > 0  # the MoE's aux is in the loss, not a zero
    assert abs(float(metrics["aux"]) - ref["loss_aux"]) <= 2 * AUX_ATOL
    assert abs(float(metrics["ce"]) - ref["ce"]) <= LOGIT_ATOL
    assert abs(float(total) - ref["total"]) <= LOGIT_ATOL


def _keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for key in tree for k in _keys(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, tuple):
        return [k for i, t in enumerate(tree) for k in _keys(t, f"{prefix}/{i}")]
    return [prefix]


def test_params_round_trip_key_for_key():
    ref = _reference(2)
    _, cfg = _model_configs(2)
    params = mdl.params_from_numpy(cfg, ref["params"], device="cpu")
    back = mdl.params_to_numpy(cfg, params)
    assert sorted(_keys(back)) == sorted(_keys(ref["params"]))
    assert "/stack/pos0/moe/shared/w_gate" in _keys(back)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_array_equal(got, want)
    # the flat vector is the reference's tree_leaves order, and views round-trip it
    flat = mdl.flatten_lm(params)
    want_flat = np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(ref["params"])])
    np.testing.assert_array_equal(flat.numpy(), want_flat)
    views = mdl.lm_views(flat, params)
    assert all(torch.equal(a, b) for a, b in zip(views.parameters(), params.parameters()))
    assert [n for n, _ in views.named_parameters()] == [n for n, _ in params.named_parameters()]


def test_full_width_parameter_count_on_meta():
    cfg = get_config(ARCH)
    params = mdl.init_params(cfg, device="meta")
    assert mdl.param_count(params) == 14_315_735_040
    expert = params.blocks[0]["moe"]
    assert tuple(expert["e_gate"].shape) == (60, 2048, 1408)
    assert tuple(expert["shared"]["w_up"].shape) == (2048, 1408 * 4)


def test_init_params_is_seeded_and_serves_on_the_cpu():
    cfg = get_config(ARCH, reduced=True)
    a, b = (mdl.init_params(cfg, 3, device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    tokens, steps = serve.generate(cfg, a, torch.zeros((2, 7), dtype=torch.long), 3, device="cpu")
    assert tuple(tokens.shape) == (2, 3) and bool(torch.isfinite(steps).all())


def test_serve_cli_serves_the_moe_arch_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "9", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill (2x9)" in out and "decoded 2 x 2 tokens" in out


def test_serve_cli_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", ARCH, "--reduced"])
