"""Kernel B4's plain version and CPU wrapper against the JAX package's.

The JAX side is ``flash_attention_padded(..., interpret=True)`` with the
16-row tiles of ``tests/test_kernels.py``, its oracle ``attention_ref`` and
the model layer's ``attend`` with ``causal_mask``. Tolerances: atol 2e-5
in f32 (the reference's own; measured ≤ 6.6e-7: the two sum in other
orders); in bf16 the outputs are bf16 of magnitude ≤ 4, so atol 1.6e-2
(two bf16 ulps at 2–4, measured 7.8e-3) against the JAX kernel, whose p
is rounded relative to a running max, and the reference's 3e-2 against
its oracle; in f16 the same two ulps at 2–4, 2⁻⁸ = 3.9e-3. Where q, k and
v mix dtypes the limit is the lowest precision's among the three.
"""
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.flash_attention.ops import flash_attention_padded as ref_flash
from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref
from repro.models.layers.attention import attend as ref_attend
from repro.models.layers.attention import causal_mask as ref_causal_mask
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_plain
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

F32_SHAPES = [(1, 32, 4, 4, 16), (2, 64, 8, 2, 32), (1, 48, 6, 1, 64), (2, 40, 4, 2, 8)]
F32_ATOL = 2e-5
BF16_ATOL = 1.6e-2
F16_ATOL = 2.0**-8
ATOL = {torch.float32: F32_ATOL, torch.bfloat16: BF16_ATOL, torch.float16: F16_ATOL}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
MIXED_SHAPES = [(1, 8, 4, 2, 16), (2, 37, 4, 2, 20)]  # the second ragged: S off the tiles, hd 20


def _limit(*dtypes) -> float:
    """The limit of the lowest precision among ``dtypes``."""
    return max(ATOL[d] for d in dtypes)


def _qkv(b, s, h, kv, hd, t=None, seed=0):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32),
            rng.normal(size=(b, t, kv, hd)).astype(np.float32))


def _ref(q, k, v, dtype=jnp.float32, causal=True):
    out = ref_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
                    block_q=16, block_k=16, interpret=True)
    return np.asarray(out, np.float32)


def _port(fn, q, k, v, dtype=torch.float32, causal=True):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), causal=causal)
    assert out.dtype == dtype and tuple(out.shape) == q.shape
    return out.float().numpy()


PORT_FNS = {"plain": flash_attention_plain, "wrapper": ops.flash_attention_padded}


@pytest.mark.parametrize("fn", PORT_FNS)
@pytest.mark.parametrize("b,s,h,kv,hd", F32_SHAPES + [(2, 37, 4, 2, 32), (1, 130, 6, 3, 128)])
def test_f32_matches_reference_kernel(fn, b, s, h, kv, hd):
    """The reference's four test shapes, a ragged S (37: not a multiple of
    the 16-row tiles) and the path's head_dim 128 at a ragged S."""
    q, k, v = _qkv(b, s, h, kv, hd)
    np.testing.assert_allclose(_port(PORT_FNS[fn], q, k, v), _ref(q, k, v), atol=F32_ATOL)


@pytest.mark.parametrize("fn", PORT_FNS)
@pytest.mark.parametrize("b,s,h,kv,hd", [(1, 32, 4, 2, 16), (2, 200, 4, 2, 32)])
def test_bf16_matches_reference_kernel_and_oracle(fn, b, s, h, kv, hd):
    q, k, v = _qkv(b, s, h, kv, hd, seed=1)
    got = _port(PORT_FNS[fn], q, k, v, torch.bfloat16)
    np.testing.assert_allclose(got, _ref(q, k, v, jnp.bfloat16), atol=BF16_ATOL)
    oracle = ref_attention_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), atol=3e-2)


@pytest.mark.parametrize("fn", PORT_FNS)
def test_non_causal_matches_reference_at_a_block_multiple(fn):
    """Non-causal calls are compared only where T is a multiple of the
    reference's tile: for a ragged T the reference pads keys with zeros and
    does not mask them (ROADMAP Queue C); the port masks k >= T."""
    q, k, v = _qkv(2, 32, 4, 2, 16, t=48)
    np.testing.assert_allclose(_port(PORT_FNS[fn], q, k, v, causal=False),
                               _ref(q, k, v, causal=False), atol=F32_ATOL)


def test_ragged_non_causal_masks_the_tail_unlike_the_reference():
    q, k, v = _qkv(1, 16, 2, 1, 8, t=20)
    got = _port(flash_attention_plain, q, k, v, causal=False)
    exact = _port(lambda *a, causal: attention_ref(*a, causal=causal), q, k, v, causal=False)
    np.testing.assert_allclose(got, exact, atol=F32_ATOL)
    assert np.abs(got - _ref(q, k, v, causal=False)).max() > 1e-3  # the reference's padded keys


@pytest.mark.parametrize("b,s,h,kv,hd", F32_SHAPES)
def test_attention_ref_copy_matches_the_reference_oracle(b, s, h, kv, hd):
    q, k, v = _qkv(b, s, h, kv, hd, seed=2)
    want = np.asarray(ref_attention_ref(*(jnp.asarray(a) for a in (q, k, v))))
    got = attention_ref(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_wrapper_matches_the_model_layer():
    """Kernel function == the reference model's attend() with causal_mask."""
    cfg = ref_get_config("qwen2-1.5b", reduced=True)
    b, s, h, kv, hd = 2, 32, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(b, s, h, kv, hd, seed=3)
    want = ref_attend(cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ref_causal_mask(s, s, 0))
    got = _port(ops.flash_attention_padded, q, k, v)
    np.testing.assert_allclose(got, np.asarray(want).reshape(b, s, h, hd), atol=F32_ATOL)


@pytest.mark.parametrize("fn", PORT_FNS)
@pytest.mark.parametrize("hd,dtype", [(12, torch.float32), (20, torch.float32), (256, torch.float32),
                                      (320, torch.float32), (256, torch.bfloat16),
                                      (96, torch.float16)])
def test_any_head_dim_and_float16_match_reference_kernel(fn, hd, dtype):
    """Head dims that are not multiples of 8, or above the tensor-core
    kernel's 256 and the f32 kernel's 128-column chunk, and float16: the
    reference's kernel takes them all, at (B, S, H, KV) = (1, 40, 4, 2)."""
    q, k, v = _qkv(1, 40, 4, 2, hd, seed=4)
    np.testing.assert_allclose(_port(PORT_FNS[fn], q, k, v, dtype), _ref(q, k, v, JNP[dtype]),
                               atol=ATOL[dtype])


@pytest.mark.parametrize("case", ["hd", "hd_large", "dtype", "mixed_dtype"])
def test_wrapper_takes_what_the_reference_takes(case):
    """Inputs the wrapper once refused: a head dim of 12 as views into
    16-wide heads, a head dim of 256, float16, and a bf16 v under f32 q and
    k."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 16))
    if case == "hd":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif case == "hd_large":
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 256))
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    else:
        v = v.bfloat16()
    got = ops.flash_attention_padded(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = ref_flash(*(jnp.asarray(a.float().numpy(), JNP[a.dtype]) for a in (q, k, v)),
                     block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_limit(q.dtype, k.dtype, v.dtype))


@pytest.mark.parametrize("bad", ["gqa", "int_dtype", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """H % KV != 0 and shapes that disagree, which the reference asserts on
    too; and an operand that is not f32, bf16 or f16."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 16))
    if bad == "gqa":
        k, v = torch.zeros((1, 8, 3, 16)), torch.zeros((1, 8, 3, 16))
    elif bad == "int_dtype":
        v = v.to(torch.int32)
    else:
        v = v[:, :4]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention_padded(q, k, v)


@functools.cache
def _mixed_ref(dtypes: tuple, shape: tuple) -> np.ndarray:
    q, k, v = _qkv(*shape, seed=7)
    return np.asarray(ref_flash(*(jnp.asarray(a, JNP[d]) for a, d in zip((q, k, v), dtypes)),
                                block_q=16, block_k=16, interpret=True), np.float32)


@pytest.mark.parametrize("fn", PORT_FNS)
@pytest.mark.parametrize("shape", MIXED_SHAPES)
@pytest.mark.parametrize("dq,dk,dv", list(itertools.product(DTYPES, repeat=3)))
def test_every_dtype_combination_matches_reference_kernel(fn, shape, dq, dk, dv):
    """All 27 combinations of f32, bf16 and f16 for q, k and v, as the
    reference computes them: f32 scores of q and k, p rounded to v's dtype
    before PV, the output in q's dtype; within the lowest precision's
    limit of the reference's kernel in interpret mode."""
    q, k, v = _qkv(*shape, seed=7)
    got = PORT_FNS[fn](*(torch.from_numpy(a).to(d) for a, d in zip((q, k, v), (dq, dk, dv))))
    assert got.dtype == dq and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), _mixed_ref((dq, dk, dv), shape),
                               atol=_limit(dq, dk, dv))


def test_gradient_at_head_dim_20_matches_autograd_of_the_plain_version():
    """``flash_attention``'s backward (``backward.py``) at a head dim that is
    not a multiple of 8, against autograd through ``flash_attention_plain``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 24, 4, 2, 20, seed=5))
    do = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape).astype(np.float32))
    grads = []
    for fn in (ops.flash_attention, flash_attention_plain):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do)
        grads.append([a.grad for a in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL)


# the tile edges of the card's wgmma route (64- and 128-row blocks, 128-key
# tiles): S = T on each side of them, and the serve prompt
EDGES = (1, 63, 64, 65, 127, 128, 129)


@functools.cache
def _edge_ref(b, s, h, kv, hd, dtype: str, t=None, causal=True, block=16):
    q, k, v = _qkv(b, s, h, kv, hd, t=t, seed=8)
    out = ref_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), causal=causal,
                    block_q=block, block_k=block, interpret=True)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", EDGES)
def test_plain_version_matches_reference_kernel_at_the_tile_edges(s, hd):
    """The card tests' oracle, ``flash_attention_plain`` in bf16, against
    the reference's kernel in interpret mode at S = T around the 64- and
    128-row blocks and 128-key tiles, at the model paths' head dims."""
    q, k, v = _qkv(2, s, 2, 2, hd, seed=8)
    got = _port(flash_attention_plain, q, k, v, torch.bfloat16)
    np.testing.assert_allclose(got, _edge_ref(2, s, 2, 2, hd, "bfloat16"), atol=BF16_ATOL)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("h,kv", [(6, 1), (8, 1), (8, 8)])
def test_plain_version_matches_reference_kernel_at_gqa_groups(h, kv, hd):
    """GQA groups of 6 and 8 query heads to a kv head, and of 1, at a
    ragged S past the 128-row block."""
    q, k, v = _qkv(1, 129, h, kv, hd, seed=8)
    got = _port(flash_attention_plain, q, k, v, torch.bfloat16)
    np.testing.assert_allclose(got, _edge_ref(1, 129, h, kv, hd, "bfloat16"), atol=BF16_ATOL)


@pytest.mark.parametrize("s", [65, 129])
def test_plain_version_matches_reference_kernel_in_float16_at_the_edges(s):
    q, k, v = _qkv(1, s, 4, 2, 96, seed=8)
    got = _port(flash_attention_plain, q, k, v, torch.float16)
    np.testing.assert_allclose(got, _edge_ref(1, s, 4, 2, 96, "float16"), atol=F16_ATOL)


def test_plain_version_matches_reference_kernel_at_the_serve_prompt():
    """S = T = 1,000, the serve prompt, at head dim 128 (the reference's
    128-row tiles, which it pads to 1,024)."""
    q, k, v = _qkv(1, 1000, 2, 1, 128, seed=8)
    got = _port(flash_attention_plain, q, k, v, torch.bfloat16)
    np.testing.assert_allclose(got, _edge_ref(1, 1000, 2, 1, 128, "bfloat16", block=128),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("t", [64, 192])
def test_plain_version_matches_reference_kernel_non_causal_past_a_tile(t):
    """Non-causal with T a multiple of the reference's tile on each side of
    the 128-key tile, S ragged (the reference masks no padded key there)."""
    q, k, v = _qkv(2, 65, 4, 2, 64, t=t, seed=8)
    got = _port(flash_attention_plain, q, k, v, torch.bfloat16, causal=False)
    np.testing.assert_allclose(got, _edge_ref(2, 65, 4, 2, 64, "bfloat16", t=t, causal=False),
                               atol=BF16_ATOL)


@pytest.mark.parametrize("variant", ["whole", "no_softmax", "no_products", "loads_only"])
def test_probe_leaves_out_what_each_variant_names(variant):
    """``turns.py --probe``'s variants of the committed source: the softmax
    call and the two wgmma issues are each found once, and each variant
    drops the parts it names and keeps the rest."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import turns

    src = (_build.CSRC / "flash_attention.cu").read_text()
    parts = turns.PROBE[variant]
    got = turns.probe_source(src, parts)
    assert (turns.PROBE_SOFTMAX in got) == ("softmax" not in parts)
    for line in turns.PROBE_PRODUCTS:
        assert (line in got) == ("products" not in parts)
        assert (line.replace("Wgmma", "if (0) Wgmma") in got) == ("products" in parts)
    with pytest.raises(RuntimeError, match="copies"):
        turns.probe_source(src.replace(turns.PROBE_SOFTMAX, ""), ("softmax",))
