"""The port's LM layers against the JAX package's, on the same numpy inputs.

Tolerance atol 1e-5 in f32 (measured ≤ 2e-6: f32 sums in other orders;
the rope angles at positions up to 1,000 with theta 1e6 agree to 2e-5
relative through the f32 pow and product, so those take rtol 1e-5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.layers import attention as ref_attn
from repro.models.layers import mlp as ref_mlp
from repro.models.layers import norms as ref_norms
from repro.models.layers import rotary as ref_rotary
from repro_torch.configs import get_config
from repro_torch.models import blocks
from repro_torch.models.layers import attention, mlp, norms, rotary
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ATOL = 1e-5
RNG = np.random.default_rng(0)


def _np(*shape, scale=1.0):
    return (scale * RNG.normal(size=shape)).astype(np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def test_norms():
    x, scale, bias = _np(2, 5, 64), 1 + _np(64, scale=0.1), _np(64, scale=0.1)
    _close(norms.rmsnorm({"scale": _t(scale)}, _t(x)), ref_norms.rmsnorm({"scale": scale}, x))
    _close(norms.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           ref_norms.layernorm({"scale": scale, "bias": bias}, x))
    xh = _np(2, 5, 3, 32)
    _close(norms.rms_head_norm(_t(scale[:32]), _t(xh)), ref_norms.rms_head_norm(scale[:32], xh))


@pytest.mark.parametrize("hd,theta", [(32, 1e6), (128, 1e6), (64, 5e5)])
def test_rope_angles_and_apply(hd, theta):
    pos = np.arange(1000)
    want = ref_rotary.rope_angles(jnp.asarray(pos), hd, theta)
    got = rotary.rope_angles(torch.from_numpy(pos), hd, theta)
    _close(got, want, atol=0.0, rtol=1e-5)
    x = _np(2, 1000, 3, hd)
    _close(rotary.apply_rope(_t(x), got), ref_rotary.apply_rope(x, np.asarray(got.numpy())))


def test_apply_rope_rotates_interleaved_pairs():
    """Pair (x[2i], x[2i+1]) turns by angle i; a half-split rope would mix x[i] and x[i + hd/2]."""
    x = torch.zeros((1, 1, 1, 4))
    x[..., 0] = 1.0
    got = rotary.apply_rope(x, torch.tensor([[np.pi / 2, 0.0]]))
    np.testing.assert_allclose(got.flatten().numpy(), [0.0, 1.0, 0.0, 0.0], atol=1e-6)


def _cfg(name="qwen2-1.5b", **kw):
    return (dataclasses.replace(ref_get_config(name, reduced=True), **kw),
            dataclasses.replace(get_config(name, reduced=True), **kw))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(act, gated):
    ref_cfg, cfg = _cfg(act=act)
    p = {"w_up": _np(128, 256, scale=0.1), "w_down": _np(256, 128, scale=0.1)}
    if gated:
        p["w_gate"] = _np(128, 256, scale=0.1)
    x = _np(2, 7, 128)
    _close(mlp.mlp(cfg, _t(p), _t(x)), ref_mlp.mlp(ref_cfg, p, x))


def _attn_params(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {"wq": _np(d, h * hd, scale=d**-0.5), "wk": _np(d, kv * hd, scale=d**-0.5),
         "wv": _np(d, kv * hd, scale=d**-0.5), "wo": _np(h * hd, d, scale=(h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_np(h * hd, scale=0.1), bk=_np(kv * hd, scale=0.1), bv=_np(kv * hd, scale=0.1))
    if cfg.qk_norm:
        p.update(q_norm=1 + _np(hd, scale=0.1), k_norm=1 + _np(hd, scale=0.1))
    return p


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-0.6b", "llama3.2-3b"])
def test_qkv(name):
    ref_cfg, cfg = _cfg(name)
    p, x = _attn_params(cfg), _np(2, 9, cfg.d_model)
    angles = ref_rotary.rope_angles(jnp.arange(9), cfg.resolved_head_dim, cfg.rope_theta)
    want = ref_attn.qkv(ref_cfg, p, x, angles)
    got = attention.qkv(cfg, _t(p), _t(x), _t(angles))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 30.0)])
def test_attend_and_attention_full(window, softcap):
    """attend with the causal (and sliding-window) mask; attention_full
    through the flash path (window 0, no softcap) and through attend."""
    ref_cfg, cfg = _cfg(logit_softcap=softcap)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _np(2, 11, h, hd), _np(2, 11, kv, hd), _np(2, 11, kv, hd)
    mask = ref_attn.causal_mask(11, 11, 0, window)
    _close(attention.attend(cfg, _t(q), _t(k), _t(v), attention.causal_mask(11, 11, 0, window)),
           ref_attn.attend(ref_cfg, q, k, v, mask))
    p, x = _attn_params(cfg), _np(2, 11, cfg.d_model)
    angles = ref_rotary.rope_angles(jnp.arange(11), hd, cfg.rope_theta)
    y, kvd = ref_attn.attention_full(ref_cfg, p, x, angles, window=window)
    got_y, got_kv = attention.attention_full(cfg, _t(p), _t(x), _t(angles), window=window)
    _close(got_y, y)
    _close(got_kv["k"], kvd["k"])


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_against_a_cache(window):
    """Three decode steps into a full cache, and into a ring of 4 slots
    after a 6-token prefill (pack_kv_cache rolls the tail)."""
    ref_cfg, cfg = _cfg()
    p = _attn_params(cfg)
    hd = cfg.resolved_head_dim
    x = _np(2, 6, cfg.d_model)
    angles = ref_rotary.rope_angles(jnp.arange(6), hd, cfg.rope_theta)
    _, kvd = ref_attn.attention_full(ref_cfg, p, x, angles, window=window)
    from repro.models.blocks import pack_kv_cache as ref_pack

    ref_cache = ref_pack(kvd, 10, window, jnp.float32)
    cache = blocks.pack_kv_cache({"k": _t(kvd["k"]), "v": _t(kvd["v"])}, 10, window, torch.float32)
    _close(cache["k"], ref_cache["k"])
    for step in range(3):
        xt = _np(2, 1, cfg.d_model)
        a = ref_rotary.rope_angles(jnp.asarray([6 + step]), hd, cfg.rope_theta)
        y, ref_cache = ref_attn.attention_decode(ref_cfg, p, xt, a, ref_cache, window=window)
        got, cache = attention.attention_decode(cfg, _t(p), _t(xt), _t(a), cache, window=window)
        _close(got, y)
        _close(cache["v"], ref_cache["v"])
        assert cache["pos"] == int(ref_cache["pos"]) == 7 + step


def test_norm_initialisers_equal_reference():
    """``init_rmsnorm`` and ``init_layernorm``: the reference's keys, shapes
    and values (unit f32 scale, zero f32 bias), on the device asked for."""
    for got, want in ((norms.init_rmsnorm(48, device="cpu"), ref_norms.init_rmsnorm(48)),
                      (norms.init_layernorm(48, device="cpu"), ref_norms.init_layernorm(48))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert norms.init_rmsnorm(4, device="meta")["scale"].device.type == "meta"


@pytest.mark.parametrize("gated", [True, False])
def test_init_mlp_carried_weights_match_reference(gated):
    """``init_mlp(..., gated=)``: the reference's keys and shapes; the
    reference's weights carried across give the reference's MLP (atol
    1e-5, as ``test_mlp``)."""
    import jax

    ref_cfg, cfg = _cfg(act="silu")
    want_p = ref_mlp.init_mlp(128, 256, jax.random.PRNGKey(0), gated=gated)
    got_p = mlp.init_mlp(128, 256, torch.Generator().manual_seed(0), "cpu", gated=gated)
    assert sorted(got_p) == sorted(want_p)
    assert all(tuple(got_p[k].shape) == want_p[k].shape for k in want_p)
    x = _np(2, 7, 128)
    carried = {k: np.asarray(v) for k, v in want_p.items()}
    _close(mlp.mlp(cfg, _t(carried), _t(x)), ref_mlp.mlp(ref_cfg, want_p, x))
