"""The port's LM (prefill + greedy decode) against the JAX package's.

The reference's random parameters, with every bias and norm scale moved
off its init value by numpy noise, carry across to the port through
``params_from_numpy``; the same numpy prompts go through both. The JAX
side runs once per config (jitted prefill and decode) and is shared by the
tests of that config. Tolerances: f32 hidden states and logits (scale ~4)
agree to atol 2e-5 (measured ≤ 3.1e-6: the two sum in other orders), and
greedy token ids are equal. In bf16 the reference's ``attend`` rounds its
scores to bf16 (the einsum runs in the input dtype) while the port's flash
kernel keeps them in f32, so logits agree to atol 0.1, three bf16 ulps at
their scale (measured 0.047), and greedy tokens are compared wherever the
reference's top-2 margin exceeds twice the step's max |Δlogit|.
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
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.models import model as mdl
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

B, P, GEN = 2, 19, 6
F32_ATOL = 2e-5
BF16_ATOL = 0.1

CASES = {
    "qwen2-1.5b": ("qwen2-1.5b", {}),
    "qwen2-1.5b[2 layers]": ("qwen2-1.5b", {"n_layers": 2}),
    "qwen3-0.6b": ("qwen3-0.6b", {}),
    "llama3.2-3b": ("llama3.2-3b", {}),
}
BF16 = ("qwen2-1.5b", {"n_layers": 2, "dtype": "bfloat16"})


def _configs(name, overrides):
    ref = dataclasses.replace(ref_get_config(name, reduced=True), **overrides)
    port = dataclasses.replace(get_config(name, reduced=True), **overrides)
    return ref, port


@functools.cache
def _reference(name, overrides_items):
    """The reference's params (as numpy), prompts, hidden, logits, tokens
    and per-step logits for one reduced config."""
    cfg, _ = _configs(name, dict(overrides_items))
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
        hidden, caches, _ = ref_model.forward(cfg, params, tokens, caches=caches)
        return hidden, ref_model.logits_from_hidden(cfg, params, hidden), caches

    decode = jax.jit(lambda params, tok, caches: ref_model.decode_step(cfg, params, tok, caches))
    hidden, logits, caches = prefill(params, prompts)
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
                steps=np.stack(steps))


def _port(name, overrides):
    ref = _reference(name, tuple(sorted(overrides.items())))
    _, cfg = _configs(name, overrides)
    return ref, cfg, mdl.params_from_numpy(cfg, ref["params"], device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(case):
    ref, cfg, params = _port(*CASES[case])
    with torch.inference_mode():
        hidden, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long())
        logits = mdl.logits_from_hidden(cfg, params, hidden)
    assert caches is None
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], atol=F32_ATOL)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=F32_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_prefill_then_decode_matches_reference_at_every_step(case):
    ref, cfg, params = _port(*CASES[case])
    before = flash_ops.launches["flash_attention"]
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    assert tuple(steps.shape) == (GEN, B, cfg.vocab_size)
    np.testing.assert_allclose(steps.numpy(), ref["steps"], atol=F32_ATOL)
    np.testing.assert_array_equal(tokens.numpy(), ref["tokens"])
    # on the CPU the wrapper runs its plain version and counts nothing
    assert flash_ops.launches["flash_attention"] == before


def test_bf16_prefill_and_decode_match_reference():
    ref, cfg, params = _port(*BF16)
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    assert steps.dtype == torch.bfloat16
    np.testing.assert_allclose(steps.float().numpy(), ref["steps"], atol=BF16_ATOL)
    with torch.inference_mode():
        hidden, _, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long())
    np.testing.assert_allclose(hidden.float().numpy(), ref["hidden"], atol=BF16_ATOL)


def test_bf16_greedy_tokens_match_reference_where_the_margin_decides():
    """The bf16 greedy tokens equal the reference's at every step of a row up
    to the first one where the reference's top-2 margin is not above twice
    that step's max |Δlogit|; past it a near tie may go either way and the
    rows may part. Here row 0 is decided for 4 steps of 6 (step 4: margin
    0.031, max |Δlogit| 0.033), row 1 for all 6, and every decided token is
    equal."""
    ref, cfg, params = _port(*BF16)
    tokens, steps = serve.generate(cfg, params, torch.from_numpy(ref["prompts"]).long(), GEN,
                                   device="cpu")
    got = steps.float().numpy()
    top2 = np.sort(ref["steps"], axis=-1)[..., -2:]
    for b in range(B):
        decided = 0
        for t in range(GEN):
            gap = float(np.abs(got[t, b] - ref["steps"][t, b]).max())
            margin = float(top2[t, b, 1] - top2[t, b, 0])
            if margin <= 2 * gap:
                break
            assert tokens[b, t].item() == ref["tokens"][b, t], (
                f"row {b}, step {t}: token {tokens[b, t].item()} != the reference's "
                f"{ref['tokens'][b, t]} at a top-2 margin {margin:.4f} > 2 × max |Δlogit| "
                f"{gap:.4f}: the fault is the routing of bf16 prefill attention to the flash "
                "kernel (models/layers/attention.py), not the kernel")
            decided += 1
        assert decided >= 1, f"row {b}: the prefill's token is not decided by its margin"


def test_prefill_seeds_the_cache_like_the_reference():
    """The prefill's packed cache holds the reference's rotated k and v."""
    name, overrides = CASES["qwen2-1.5b[2 layers]"]
    ref_cfg, cfg = _configs(name, overrides)
    ref, _, params = _port(name, overrides)
    ref_caches = ref_model.init_cache(ref_cfg, B, P + GEN)
    _, ref_caches, _ = ref_model.forward(ref_cfg, ref["params"], ref["prompts"], caches=ref_caches)
    caches = mdl.init_cache(cfg, B, P + GEN, device="cpu")
    with torch.inference_mode():
        _, caches, _ = mdl.forward(cfg, params, torch.from_numpy(ref["prompts"]).long(), caches=caches)
    assert caches["pos"] == P
    for layer in range(cfg.n_layers):
        for kv in ("k", "v"):
            want = np.asarray(ref_caches["stack"]["pos0"][kv][layer])
            np.testing.assert_allclose(caches["layers"][layer][kv].numpy(), want, atol=F32_ATOL)
        assert caches["layers"][layer]["pos"] == P


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_every_config_is_ported(name):
    """``check_ported`` accepts each of the reference's 10 configs: the
    reduced config's parameters and cache build on the CPU, one cache per
    layer (an encoder-decoder's with cross-attention's ``ck`` / ``cv``)."""
    cfg = get_config(name, reduced=True)
    mdl.check_ported(cfg)
    params = mdl.init_params(cfg, device="cpu")
    caches = mdl.init_cache(cfg, 1, 4, device="cpu")
    assert len(params.blocks) == len(caches["layers"]) == cfg.n_layers
    assert (params.encoder is not None) == (cfg.encoder is not None)
    if cfg.encoder is not None:
        assert all(tuple(c["ck"].shape) == (1, cfg.encoder.n_frames, cfg.n_kv_heads,
                                            cfg.resolved_head_dim) for c in caches["layers"])


def test_check_ported_names_a_decoder_block_it_does_not_run():
    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True), pattern=(("bidir", "mlp"),))
    with pytest.raises(NotImplementedError, match=r"decoder block \('bidir', 'mlp'\) not ported"):
        mdl.init_params(cfg, device="cpu")


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--reduced", "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill (2x9)" in out and "decoded 3 x 2 tokens" in out
    rows = [line for line in out.splitlines() if line.strip().startswith("[")]
    assert len(rows) == 2 and all(len(eval(r)) == 4 for r in rows)


def test_init_params_is_seeded():
    cfg = get_config("qwen2-1.5b", reduced=True)
    a, b = (mdl.init_params(cfg, 3, device="cpu") for _ in range(2))
    c = mdl.init_params(cfg, 4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert not any(p.requires_grad for p in a.parameters())
