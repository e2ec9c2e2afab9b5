"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA GPU every test here skips.
"""
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.aggregate.ops import aggregate_flat
from repro_torch.kernels.aggregate.ref import aggregate_ref
from repro_torch.kernels.similarity import ops
from repro_torch.kernels.similarity.ref import gram_ref, l1_ref
from repro_torch.kernels.sketch import ops as sk_ops
from repro_torch.kernels.sketch.ref import sketch_srp_plain, srp_sign_block
from repro_torch.testing import pin_cpu_threads, thread_env

pin_cpu_threads()

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


# the gates' shapes; n on both sides of the 8- and 16-row groups and of the
# 128-row tile (16, 17, 33, 129); d % 4 != 0 with several splits (1001,
# 4099); one split at n = 33 and at the sketched store's (100, 64)
SIM_SHAPES = [(13, 101), (100, 39760), (100, 64), (257, 8193), (1, 1), (16, 256), (17, 1001),
              (33, 100), (129, 4099)]


@pytest.mark.parametrize("n,d", SIM_SHAPES)
@pytest.mark.parametrize("op", ["gram", "l1"])
def test_similarity_kernel_matches_plain(cuda, op, n, d):
    # update scale, as in tests/test_torch_similarity.py
    G = torch.from_numpy((1e-3 * np.random.default_rng(3).normal(size=(n, d))).astype(np.float32)).to(cuda)
    got = ops.pairwise_sums(G, op)
    want = gram_ref(G) if op == "gram" else l1_ref(G)
    torch.cuda.synchronize()
    if op == "gram":
        # Gram entries are ~1e-6·d here, so the tolerance is relative to
        # ‖g_i‖·‖g_j‖: |got − want| ≤ 1e-5·‖g_i‖·‖g_j‖
        norms = G.double().norm(dim=1)
        err = (got.double() - want.double()).abs() / (norms[:, None] * norms[None, :])
        assert float(err.max()) <= 1e-5
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    # fixed-order split reduction: bit-reproducible from run to run
    np.testing.assert_array_equal(got.cpu().numpy(), ops.pairwise_sums(G, op).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), got.T.cpu().numpy())


# the main path's (11, 39,760), bench_round_engine's (41, 39,760), a ragged
# p, k of several 8-row passes (300), odd p with rows off alignment
AGG_SHAPES = [(11, 39760), (41, 39760), (11, 39759), (300, 4099), (3, 1001), (1, 1), (17, 2)]


def _agg_inputs(k, p, seed=4):
    rng = np.random.default_rng(seed)
    U = torch.from_numpy(rng.normal(size=(k, p)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(k,)).astype(np.float32)).cuda()
    return U, w


@pytest.mark.parametrize("k,p", AGG_SHAPES)
def test_aggregate_kernel_matches_plain(cuda, k, p):
    U, w = _agg_inputs(k, p)
    got = aggregate_flat(U, w)
    want = aggregate_ref(U, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("k,p", AGG_SHAPES)
def test_aggregate_kernel_is_bit_reproducible(cuda, k, p):
    U, w = _agg_inputs(k, p)
    assert torch.equal(aggregate_flat(U, w), aggregate_flat(U, w))


@pytest.mark.parametrize("k,p", AGG_SHAPES)
def test_aggregate_kernel_same_bits_in_any_layout(cuda, k, p):
    """One fixed FMA order for every column: the same values 4 bytes off
    alignment, and with one more column (other row alignments), sum to the
    same bits as the aligned call."""
    U, w = _agg_inputs(k, p)
    got = aggregate_flat(U, w)
    flat = torch.empty(k * p + 1, device=cuda)
    shifted = flat[1:].view(k, p)
    shifted.copy_(U)
    wide = torch.cat([U, torch.ones((k, 1), device=cuda)], dim=1)
    assert torch.equal(aggregate_flat(shifted, w), got)
    assert torch.equal(aggregate_flat(wide, w)[:p], got)


@pytest.mark.parametrize("k,p", [(11, 39760), (41, 39760), (11, 39759)])
def test_aggregate_kernel_launches_a_call(cuda, k, p):
    """One aggregate_ device kernel a call and nothing else (no copy, no
    fill), and one count a call."""
    U, w = _agg_inputs(k, p)
    before = agg_ops.launches["aggregate"]
    aggregate_flat(U, w)
    assert agg_ops.launches["aggregate"] == before + 1
    events = _device_kernels(lambda: aggregate_flat(U, w))
    # the profiler may drop a launch or two of a window it keeps
    assert 18 <= len(events) <= 20
    assert all("aggregate_" in e for e in events)


def test_aggregate_wrapper_raises_instead_of_falling_back(cuda):
    U, w = _agg_inputs(3, 8)
    with pytest.raises(ValueError):
        aggregate_flat(U, w.cpu())
    with pytest.raises(ValueError):
        aggregate_flat(U.T, torch.zeros(8, device=cuda))  # not contiguous
    with pytest.raises(TypeError):
        aggregate_flat(U.half(), w)


def _device_kernels(fn, reps=20):
    """Names of the device events torch.profiler keeps of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler on the card sometimes keeps no event of a window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


@pytest.mark.parametrize("n,d,kernels", [(100, 39760, ("pairwise_partial", "pairwise_reduce")),
                                         (100, 64, ("pairwise_partial",))])
def test_similarity_kernel_launches_a_call(cuda, n, d, kernels):
    """Two device kernels a call where d is split, one where it is not, and
    nothing else (no copy, no fill)."""
    G = _x(n, d).to(cuda)
    events = _device_kernels(lambda: ops.pairwise_sums(G, "gram"))
    # the profiler may drop a launch or two of a window it keeps
    for name in kernels:
        assert 18 <= sum(name in e for e in events) <= 20
    assert all(any(name in e for name in kernels) for e in events)


def test_launch_counters_count_kernel_launches(cuda):
    G = torch.ones((4, 8), device=cuda)
    before = dict(ops.launches)
    ops.pairwise_distances_device(G, "arccos")
    ops.pairwise_distances_streamed(G, "l1")
    assert ops.launches["gram"] == before["gram"] + 1
    assert ops.launches["l1"] == before["l1"] + 1


def _x(c, d, seed=5):
    """(c, d) f32 rows at update scale."""
    return torch.from_numpy((1e-3 * np.random.default_rng(seed).normal(size=(c, d))).astype(np.float32))


# the round's and the fleet's shapes; c = 130 spans three row tiles; d = 96
# and 100 have fewer k-tiles than splits
SRP_SHAPES = [(10, 39760, 64), (64, 39760, 64), (13, 1037, 64), (8, 96, 8), (3, 100, 130),
              (130, 39760, 64), (5, 96, 64)]


@pytest.mark.parametrize("c,d,d_prime", SRP_SHAPES)
def test_srp_kernel_matches_plain(cuda, c, d, d_prime):
    X = _x(c, d).to(cuda)
    got = sk_ops.srp_sketch(X, d_prime, 7)
    want = sketch_srp_plain(X, d_prime, 7)
    torch.cuda.synchronize()
    # |got − want| ≤ 1e-5·‖x_i‖·‖S_:,j‖ with ‖S_:,j‖ = √(d/d'): the scale of an entry
    scale = X.double().norm(dim=1)[:, None] * (d / d_prime) ** 0.5
    assert float(((got.double() - want.double()).abs() / scale).max()) <= 1e-5
    np.testing.assert_array_equal(got.cpu().numpy(), sk_ops.srp_sketch(X, d_prime, 7).cpu().numpy())


def test_srp_kernel_signs_are_the_plain_bits(cuda):
    """Each output of the identity rows has one nonzero term: it is S exactly."""
    d = 1037
    got = sk_ops.srp_sketch(torch.eye(d, device=cuda), 64, 12_345)
    want = srp_sign_block(12_345, 0, d, 64, d, device=cuda)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want.cpu().numpy().view(np.uint32))


def test_srp_kernel_rows_do_not_depend_on_the_batch(cuda):
    X = _x(64, 39760).to(cuda)
    full = sk_ops.srp_sketch(X, 64, 0)
    for lo, hi in ((0, 5), (7, 8), (30, 64)):
        part = sk_ops.srp_sketch(X[lo:hi].contiguous(), 64, 0)
        np.testing.assert_array_equal(part.cpu().numpy(), full[lo:hi].cpu().numpy())


def test_srp_kernel_back_to_back_calls_match_alone(cuda):
    """Back-to-back calls at alternating shapes, unsynchronised, are each
    bit-equal to the same call made alone."""
    inputs = [(_x(c, d, seed=c + d).to(cuda), d_prime) for c, d, d_prime in SRP_SHAPES]
    alone = []
    for X, d_prime in inputs:
        alone.append(sk_ops.srp_sketch(X, d_prime, 7).cpu().numpy())
    got = [sk_ops.srp_sketch(X, d_prime, 7) for _ in range(3) for X, d_prime in inputs]
    for i, y in enumerate(got):
        np.testing.assert_array_equal(y.cpu().numpy(), alone[i % len(inputs)])


def test_srp_kernel_is_two_device_kernels_a_call(cuda):
    """The partial pass and the reduce pass, once each a call, and nothing
    else (no copy, no fill)."""
    from torch.profiler import ProfilerActivity, profile

    X = _x(10, 39760).to(cuda)
    sk_ops.srp_sketch(X, 64, 7)
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler on the card sometimes keeps no event of a window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                sk_ops.srp_sketch(X, 64, 7)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    # and it may drop a launch or two of one it keeps
    for name in ("srp_partial", "srp_reduce"):
        assert 18 <= sum(name in e.name for e in events) <= 20
    assert all("srp_partial" in e.name or "srp_reduce" in e.name for e in events)


def test_srp_wrapper_raises_instead_of_falling_back(cuda):
    X = _x(4, 64).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sk_ops.srp_sketch(X.T, 8, 0)
    with pytest.raises(TypeError):
        sk_ops.srp_sketch(X.double(), 8, 0)


def test_srp_launch_count_counts_kernel_launches(cuda):
    from repro_torch.fl.gradient_store import GradientStore

    store = GradientStore(10, 200, sketch="srp", sketch_dim=8, device=cuda)
    before = sk_ops.launches["srp"]
    store.update([1, 2, 2], _x(3, 200).to(cuda))
    store.scatter_scaled([3], _x(1, 200).to(cuda), scale=0.5)
    store.update([11], _x(1, 200).to(cuda))  # every row dropped: no launch
    assert sk_ops.launches["srp"] == before + 2


def test_countsketch_is_bit_reproducible_on_the_card(cuda):
    from repro_torch.kernels.sketch.ops import CountSketcher

    X = _x(64, 39760).to(cuda)
    cs = CountSketcher(39760, 64, 3)
    np.testing.assert_array_equal(cs(X).cpu().numpy(), cs(X).cpu().numpy())
    np.testing.assert_allclose(cs(X).cpu().numpy(), cs(X.cpu()).numpy(), rtol=1e-5, atol=1e-7)


def test_kmeans_zero_row_tie_breaks_as_on_the_cpu(cuda):
    """The zero-row tie of tests/test_torch_clustering.py resolves alike on
    the card and the CPU: the centroid norms are summed in one fixed order."""
    from repro_torch.core.clustering.device import kmeans_labels

    G = np.random.default_rng(1).normal(size=(20, 6)).astype(np.float32)
    G[::5] = 0.0
    want = kmeans_labels(torch.from_numpy(G), 4, seed=0)
    got = kmeans_labels(torch.from_numpy(G).to(cuda), 4, seed=0)
    np.testing.assert_array_equal(got, want)


def test_ward_device_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core.clustering.device import ward_linkage_device

    X = np.random.default_rng(2).normal(size=(60, 8))
    dist = torch.from_numpy(np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1)))
    want = ward_linkage_device(dist)
    got = ward_linkage_device(dist.to(cuda))
    np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5)


FLASH_SHAPES = [(1, 32, 4, 4, 16), (2, 64, 8, 2, 32), (1, 48, 6, 1, 64), (2, 40, 4, 2, 8),
                (1, 1000, 4, 2, 128), (2, 77, 12, 2, 128), (4, 1000, 12, 2, 128),
                # every padded head dim of the bf16 kernel (32, 64, 128), pad columns
                # inside a 16-column k-step (hd 8, 72), ragged S = T around its
                # 64-row q-tiles and 64-key k-tiles
                (2, 70, 4, 2, 8), (1, 32, 4, 2, 16), (1, 96, 4, 1, 32), (1, 130, 6, 2, 64),
                (1, 77, 4, 2, 72), (2, 1, 4, 2, 128), (1, 63, 4, 2, 128), (1, 65, 8, 2, 128)]
# head dims the reference takes beyond those: below 8, not a multiple of 8
# (copied 8, 4 or 2 bytes at a time in bf16 and f16), the f32 kernel's
# 128-column chunks (200, 256, 320), the tensor-core kernel's HDP 256 and
# its 128-column chunks above it (320), at ragged S = T
FLASH_WIDE_SHAPES = [(2, 37, 4, 2, 1), (1, 70, 4, 2, 12), (2, 50, 4, 1, 20), (1, 77, 4, 2, 96),
                     (1, 130, 4, 2, 200), (2, 65, 4, 2, 256), (1, 100, 4, 2, 320)]


def _flash_inputs(b, s, h, kv, hd, dtype, t=None, seed=6):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)
                 for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


def _flash_limit(want, q, k, v, causal=True):
    """atol 2e-5 in f32; in bf16 min(3e-2, 2^-7·(|want| + Σ_j p_ij|v_j|)),
    two units of roundoff (2^-8), and in f16 the same with f16's (2^-11):
    the limits of chip_smoke.py's flash check, at the lowest precision
    among q, k and v."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    dtypes = {q.dtype, k.dtype, v.dtype}
    if dtypes == {torch.float32}:
        return 2e-5
    rel = 2.0**-7 if torch.bfloat16 in dtypes else 2.0**-10
    scale = want.float().abs() + flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                                       causal=causal)
    return (rel * scale).clamp(max=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, s, h, kv, hd, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _flash_inputs(b, s, h, kv, hd, dtype)
    got = fa_ops.flash_attention_padded(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(((got.float() - want.float()).abs() <= _flash_limit(want, q, k, v)).all())
    # fixed k order: bit-reproducible from call to call
    assert torch.equal(got, fa_ops.flash_attention_padded(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [48, 70])
def test_flash_kernel_non_causal_masks_keys_past_t(cuda, t, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _flash_inputs(2, 33, 4, 2, 32, dtype, t=t)
    got = fa_ops.flash_attention_padded(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    limit = _flash_limit(want, q, k, v, causal=False)
    assert bool(((got.float() - want.float()).abs() <= limit).all())
    assert torch.equal(got, fa_ops.flash_attention_padded(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k, v as views into the fused (B, S, (H + 2·KV)·hd) projection: the
    kernel reads them by strides (16-byte copies in bf16), matches their
    contiguous copies bit for bit and the plain version within its limit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    b, s, h, kv, hd = 2, 50, 4, 2, 32
    fused = torch.randn((b, s, (h + 2 * kv) * hd), device=cuda).to(dtype)
    q = fused[..., : h * hd].unflatten(-1, (h, hd))
    k = fused[..., h * hd: (h + kv) * hd].unflatten(-1, (kv, hd))
    v = fused[..., (h + kv) * hd:].unflatten(-1, (kv, hd))
    assert not q.is_contiguous()
    got = fa_ops.flash_attention_padded(q, k, v)
    want = fa_ops.flash_attention_padded(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    plain = flash_attention_plain(q, k, v)
    assert bool(((got.float() - plain.float()).abs() <= _flash_limit(plain, q, k, v)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,h,kv,hd", FLASH_WIDE_SHAPES)
def test_flash_kernel_takes_any_head_dim(cuda, b, s, h, kv, hd, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _flash_inputs(b, s, h, kv, hd, dtype)
    before = fa_ops.launches["flash_attention"]
    got = fa_ops.flash_attention_padded(q, k, v)
    assert fa_ops.launches["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(((got.float() - want.float()).abs() <= _flash_limit(want, q, k, v)).all())
    assert torch.equal(got, fa_ops.flash_attention_padded(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_folds_batch_and_heads_past_the_grid_axes(cuda, dtype):
    """B·H = 132,000 and H = 66,000, past the 65,535 of a grid's y and z
    axes: the one grid axis takes them."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _flash_inputs(2, 3, 66_000, 6, 16, dtype)
    got = fa_ops.flash_attention_padded(q, k, v)
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= _flash_limit(want, q, k, v)).all())


@pytest.mark.parametrize("case", ["float16", "hd_12", "hd_256", "hd_stride", "bf16_hd_stride",
                                  "bf16_misaligned_base", "bf16_seq_stride"])
def test_flash_wrapper_launches_where_it_once_raised(cuda, case):
    """Inputs the wrapper once refused launch the kernel, once a call, and
    match the plain version; the bf16 views (a head-dim stride of 2, a base
    2 bytes past 16-byte alignment, a sequence stride of 68) also match
    their contiguous copies bit for bit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _flash_inputs(1, 8, 4, 2, 16, torch.float32)
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "hd_12":
        q, k, v = (a[..., :12].contiguous() for a in (q, k, v))
    elif case == "hd_256":
        q, k, v = _flash_inputs(1, 8, 4, 2, 256, torch.float32)
    elif case == "hd_stride":
        q = torch.randn((1, 8, 4, 32), device=cuda)[..., ::2]
    else:
        flat = torch.randn(2048, device=cuda).to(torch.bfloat16)
        k, v = (a.to(torch.bfloat16) for a in (k, v))
        if case == "bf16_hd_stride":
            q = flat[:1024].view(1, 8, 4, 32)[..., ::2]
        elif case == "bf16_misaligned_base":
            q = flat[1:513].view(1, 8, 4, 16)
        else:
            q = flat[: 8 * 68].view(1, 8, 68)[..., :64].unflatten(-1, (4, 16))
    before = fa_ops.launches["flash_attention"]
    got = fa_ops.flash_attention_padded(q, k, v)
    assert fa_ops.launches["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert bool(((got.float() - want.float()).abs() <= _flash_limit(want, q, k, v)).all())
    if case.startswith("bf16_"):
        assert torch.equal(got, fa_ops.flash_attention_padded(q.contiguous(), k, v))


# The wgmma route (bf16 and f16, 32 < hd <= 128): each test runs its calls in
# a child process (tests/_torch_wgmma_child.py) with a time limit, so that a
# barrier that never completes fails that test and not the run.
WGMMA_CHILD = Path(__file__).resolve().parent / "_torch_wgmma_child.py"
WGMMA_LIMIT_S = 300


def _wgmma_child(case: dict) -> None:
    proc = subprocess.run([sys.executable, str(WGMMA_CHILD), json.dumps(case)], capture_output=True,
                          text=True, timeout=WGMMA_LIMIT_S, env=thread_env())
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


@pytest.mark.parametrize("hd", [33, 64, 96, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_wgmma_route_at_the_tile_edges(cuda, dtype, hd):
    """S = T of 1, 63, 64, 65, 127, 128, 129 and 1,000, S != T causal and
    not, GQA groups of 1, 6 and 8: each call within the limit of the plain
    version, bit-equal to a second call and to each repeat of its batch in
    a call that takes 128-row items where it takes 64-row ones."""
    _wgmma_child({"kind": "edges", "dtype": dtype, "hd": hd})


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_wgmma_route_copies_views_tma_cannot_read(cuda, dtype):
    """A sequence stride of 68 at hd 64, a base 2 bytes past 16-byte
    alignment at hd 128, a head stride of 100 at hd 96: copied by cp.async
    into the tiles TMA fills, so bit-equal to their contiguous copies."""
    _wgmma_child({"kind": "views", "dtype": dtype})


def test_flash_wgmma_route_is_the_kernel_that_runs(cuda):
    """bf16 and f16 at hd 33, 64 and 128 launch flash_fwd_wgmma, by the
    profiler's kernel names: one instance in 64-row items, another in
    128-row ones."""
    _wgmma_child({"kind": "names"})


@pytest.mark.parametrize("bad", ["h_mod_kv"])
def test_flash_wrapper_raises_instead_of_falling_back(cuda, bad):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v = _flash_inputs(1, 8, 4, 2, 16, torch.float32)
    k, v = torch.zeros((1, 8, 3, 16), device=cuda), torch.zeros((1, 8, 3, 16), device=cuda)
    before = fa_ops.launches["flash_attention"]
    with pytest.raises((ValueError, TypeError)):
        fa_ops.flash_attention_padded(q, k, v)
    assert fa_ops.launches["flash_attention"] == before


def test_flash_launch_count_counts_prefill_layers(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config("qwen2-1.5b", reduced=True), n_layers=3)
    params = init_params(cfg, 0, device=cuda)
    before = fa_ops.launches["flash_attention"]
    tokens, _ = generate(cfg, params, torch.zeros((2, 9), dtype=torch.long, device=cuda), 4, device=cuda)
    assert fa_ops.launches["flash_attention"] == before + 3  # one per layer, none in decode
    assert tokens.shape == (2, 4)


# --------------------------------------------------------------------------
# the flash route's gradient and the LM training path on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,b,s,h,kv,hd", [("float32", 2, 77, 4, 2, 64), ("float32", 1, 33, 16, 8, 128),
                                               ("bfloat16", 2, 77, 4, 2, 64), ("bfloat16", 1, 130, 16, 8, 128)])
def test_flash_function_gradients_match_autograd_through_plain(cuda, dtype, b, s, h, kv, hd):
    """The route's forward launches the kernel once and its backward is the
    torch-ops VJP: f32 to atol 2e-5, bf16 to 2⁻⁷ of the gradient's scale
    (the entries reach 4–8, where one bf16 ulp is 2⁻⁵)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    ins = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda, dt)
           for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]
    do = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32)).to(cuda, dt)
    before = fa_ops.launches["flash_attention"]
    a = [x.clone().requires_grad_(True) for x in ins]
    got = torch.autograd.grad(fa_ops.flash_attention(*a), a, do)
    assert fa_ops.launches["flash_attention"] == before + 1
    p = [x.clone().requires_grad_(True) for x in ins]
    want = torch.autograd.grad(flash_attention_plain(*p), p, do)
    for g, w in zip(got, want):
        assert g.dtype == dt
        if dt == torch.float32:
            torch.testing.assert_close(g, w, atol=2e-5, rtol=0)
        else:
            scale = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= 2.0**-7 * scale


def test_reduced_train_steps_on_the_card_match_the_cpu(cuda):
    """5 AdamW steps of the reduced qwen3-0.6b (f32) from the same
    parameters: losses and gradient norms to atol 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model as mdl
    from repro_torch.optim import adamw, linear_warmup_cosine

    cfg = get_config("qwen3-0.6b", reduced=True)
    made = mdl.init_params(cfg, 0, device="cpu")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        opt = adamw(linear_warmup_cosine(3e-3, 1, 5))
        state = steps.init_train_state(mdl.params_from_numpy(cfg, mdl.params_to_numpy(cfg, made),
                                                             device=dev), opt)
        fn = steps.make_train_step(cfg, opt)
        pipe = TokenPipeline(cfg.vocab_size, 4, 64, seed=0)
        rows = []
        for _ in range(5):
            bt = pipe.next_batch()
            state, m = fn(state, {k: torch.from_numpy(v).to(dev, torch.int64)
                                  for k, v in (("tokens", bt.tokens), ("targets", bt.targets))})
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[dev.type] = np.array(rows)
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


def test_flatten_and_unflatten_an_lm_on_the_card(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import model as mdl

    cfg = get_config("qwen2-1.5b", reduced=True)
    lm = mdl.init_params(cfg, 0, device="cpu")
    flat = mdl.flatten_lm(lm.to(cuda))
    assert flat.is_cuda
    assert torch.equal(flat.cpu(), mdl.flatten_lm(lm.cpu()))
    views = mdl.lm_views(flat, lm.to(cuda))
    assert torch.equal(mdl.flatten_lm(views), flat)


def test_bench_kernels_rows_on_the_card(cuda, capsys):
    """``bench_kernels`` on the card: each wrapper row within its kernel's
    limit of the plain version (the Gram's 1e-5·‖g_i‖·‖g_j‖, 2e-5 for the
    aggregate and the f32 flash kernel), each kernel launched, and each
    wrapper row timed at or above its H100 bound by the host clock and by
    events: a timing that did not wait for the card would time the launch."""
    from repro_torch.benchmarks import bench_kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops

    before = (ops.launches["gram"], agg_ops.launches["aggregate"],
              fa_ops.launches["flash_attention"])
    bench_kernels.main(["--device", "cuda"])
    after = (ops.launches["gram"], agg_ops.launches["aggregate"], fa_ops.launches["flash_attention"])
    assert all(a > b for a, b in zip(after, before))
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        name, us, derived = line.split(",", 2)
        rows[name] = (float(us), dict(p.split("=", 1) for p in derived.split(";") if "=" in p))
    limits = {"kernels/similarity_cuda": ("gram_err", 1e-5),
              "kernels/aggregate_cuda": ("max_abs_err", 2e-5),
              "kernels/flash_attention_cuda": ("max_abs_err", 2e-5)}
    for name, (key, limit) in limits.items():
        us, f = rows[name]
        assert float(f[key].split()[0]) <= limit, name
        bound = float(f["h100_bound_ms"])
        assert us / 1e3 >= bound and float(f["event_ms"]) >= bound, name


def test_bench_timed_synchronises_the_card(cuda):
    """``common.timed`` on the card times a kernel's device work: a device
    sleep of 100,000 cycles lasts at least 50 µs at an SM clock of at most
    2 GHz (an H100's is at most 1.98), so a call times at least that."""
    from repro_torch.benchmarks.common import timed

    us, _ = timed(lambda: torch.cuda._sleep(100_000), repeats=20, device="cuda")
    assert us >= 100_000 / 2e3


# --------------------------------------------------------------------------
# the last card: each kernel launched on cuda:{count - 1} while card 0 is the
# current device (a sharded round's groups run on every card of the mesh)
# --------------------------------------------------------------------------
@pytest.fixture
def last_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: each kernel is launched on the last one while "
                    "card 0 is the current device")
    torch.cuda.set_device(0)
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.parametrize("k,p", [(11, 39760), (9, 39759)])
def test_aggregate_kernel_on_the_last_card(last_card, k, p):
    U, w = (t.to(last_card) for t in _agg_inputs(k, p))
    got = aggregate_flat(U, w)
    assert got.device == last_card and torch.cuda.current_device() == 0
    want = aggregate_ref(U, w)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)
    # the same launch plan on card 0: the same bits
    np.testing.assert_array_equal(got.cpu().numpy(), aggregate_flat(U.cuda(0), w.cuda(0)).cpu().numpy())


@pytest.mark.parametrize("op", ["gram", "l1"])
@pytest.mark.parametrize("n,d", [(100, 39760), (100, 64), (257, 8193)])
def test_similarity_kernel_on_the_last_card(last_card, op, n, d):
    G = _x(n, d).to(last_card)
    got = ops.pairwise_sums(G, op)
    assert got.device == last_card and torch.cuda.current_device() == 0
    want = gram_ref(G) if op == "gram" else l1_ref(G)
    if op == "gram":
        norms = G.double().norm(dim=1)
        err = (got.double() - want.double()).abs() / (norms[:, None] * norms[None, :])
        assert float(err.max()) <= 1e-5
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    np.testing.assert_array_equal(got.cpu().numpy(), ops.pairwise_sums(G.cuda(0), op).cpu().numpy())


@pytest.mark.parametrize("c,d,d_prime", [(10, 39760, 64), (64, 39760, 64), (13, 1037, 64)])
def test_srp_kernel_on_the_last_card(last_card, c, d, d_prime):
    X = _x(c, d).to(last_card)
    got = sk_ops.srp_sketch(X, d_prime, 7)
    assert got.device == last_card and torch.cuda.current_device() == 0
    want = sketch_srp_plain(X, d_prime, 7)
    scale = X.double().norm(dim=1)[:, None] * (d / d_prime) ** 0.5
    assert float(((got.double() - want.double()).abs() / scale).max()) <= 1e-5
    np.testing.assert_array_equal(got.cpu().numpy(), sk_ops.srp_sketch(X.cuda(0), d_prime, 7).cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd", [(4, 1000, 12, 2, 128), (2, 77, 12, 2, 64)])
def test_flash_kernel_on_the_last_card(last_card, b, s, h, kv, hd, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = (t.to(last_card) for t in _flash_inputs(b, s, h, kv, hd, dtype))
    got = fa_ops.flash_attention_padded(q, k, v)
    assert got.device == last_card and torch.cuda.current_device() == 0
    want = flash_attention_plain(q, k, v)
    assert bool(((got.float() - want.float()).abs() <= _flash_limit(want, q, k, v)).all())
    assert torch.equal(got.cuda(0), fa_ops.flash_attention_padded(q.cuda(0), k.cuda(0), v.cuda(0)))


def test_async_planner_builds_on_the_stores_card(last_card):
    """The planner's worker thread starts on card 0; it adopts the
    snapshot's card before it builds, so the Gram launches there."""
    import contextlib

    from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
    from repro_torch.core.types import ClientPopulation

    pop = ClientPopulation(np.full(20, 50))
    rows = _x(6, 300).numpy()
    plans = {}
    for dev in (last_card, torch.device("cuda", 0)):
        sampler = Algorithm2Sampler(pop, 5, update_dim=300, seed=0, planner="async", device=dev)
        with contextlib.closing(sampler) as s:
            s.sample(0)
            s.observe_updates(np.arange(6), rows)
            s.prepare_state()  # flush the worker's build
            s.sample(1)
            plans[dev.index] = np.array(s.plan.r_tokens)
    np.testing.assert_array_equal(plans[last_card.index], plans[0])


def test_sharded_train_step_tallies_b4_at_each_data_groups_position(cuda):
    """One train step of the reduced qwen3-0.6b (f32) over a 2 × 2 mesh of
    the visible cards in turn (four positions on card 0 with one card): B4
    launches once a layer at positions 0 and 2, the first of each data
    group, and nowhere else; on two cards or more each position's blocks
    sit on that position's card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, sharding, steps
    from repro_torch.launch.mesh import AXES, Mesh
    from repro_torch.models import model as mdl
    from repro_torch.models.config import InputShape

    count = torch.cuda.device_count()
    devs = np.empty((2, 2), dtype=object)
    devs.flat[:] = [torch.device("cuda", i % count) for i in range(4)]
    mesh = Mesh(devs, AXES)
    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = steps.default_optimizer()
    (state_sh, _), _, _ = dryrun.build_shardings(cfg, InputShape("t", 64, 4, "train"), mesh, "train", opt)
    state = sharding.place(steps.init_train_state(mdl.init_params(cfg, 0, device="cpu"), opt), state_sh)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=g) for k in ("tokens", "targets")}
    step = steps.make_train_step(cfg, opt, mesh=mesh)
    _build.shard_launches.clear()
    state, m = step(state, sharding.place(batch, sharding.batch_shardings(mesh, batch)))
    for d in range(count):
        torch.cuda.synchronize(d)
    got = [_build.shard_launches[("flash_attention", pos)] for pos in range(4)]
    assert got == [cfg.n_layers, 0, cfg.n_layers, 0]
    assert np.isfinite(float(m["loss"])) and m["loss"].device == mesh.devices.flat[0]
    if count >= 2:
        for placed in sharding.leaves(state):
            for pos, block in enumerate(placed.blocks):
                assert block.device == mesh.devices.flat[pos]


# mixed dtypes: every combination of f32, bf16 and f16 for q, k and v that is
# not one dtype, at one k-tile, a ragged shape and the serve path's head dim
MIXED_DTYPES = [c for c in itertools.product((torch.float32, torch.bfloat16, torch.float16),
                                             repeat=3) if len(set(c)) > 1]
MIXED_SHAPES = [(1, 32, 4, 2, 16), (2, 130, 4, 2, 20), (1, 77, 4, 2, 128)]


@pytest.mark.parametrize("b,s,h,kv,hd", MIXED_SHAPES)
@pytest.mark.parametrize("dtypes", MIXED_DTYPES, ids=str)
def test_flash_kernel_takes_mixed_dtypes(cuda, dtypes, b, s, h, kv, hd):
    """One launch a call, the output in q's dtype, within the lowest
    precision's limit of the plain version, bit-reproducible; at one k-tile
    with an f32 output and a 16-bit v, p rounded to v's dtype (the mean
    error against the plain version a quarter, at most, of the error
    against it with p unrounded)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = (a.to(d) for a, d in zip(_flash_inputs(b, s, h, kv, hd, torch.float32), dtypes))
    before = fa_ops.launches["flash_attention"]
    got = fa_ops.flash_attention_padded(q, k, v)
    again = fa_ops.flash_attention_padded(q, k, v)
    assert fa_ops.launches["flash_attention"] == before + 2
    want = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(((got.float() - want.float()).abs() <= _flash_limit(want, q, k, v)).all())
    assert torch.equal(got, again)
    if s <= 64 and q.dtype == torch.float32 and v.dtype != torch.float32:
        unrounded = flash_attention_plain(q, k, v.float())
        err = (got - want).abs().mean()
        assert 4 * err < (got - unrounded).abs().mean()


def test_aggregate_trees_is_one_launch(cuda):
    """``aggregate_trees`` over the MNIST MLP's dicts: one B2 launch a call,
    bit-equal to ``aggregate_flat`` over the same flat rows."""
    from repro_torch.fl.aggregation import flatten_params, unflatten_params
    from repro_torch.models.simple import init_mlp

    like = init_mlp((784, 50, 10), seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    trees = [{key: 1e-3 * torch.randn(v.shape, generator=gen, device=cuda) for key, v in like.items()}
             for _ in range(11)]
    w = torch.rand(11, generator=gen, device=cuda)
    before = agg_ops.launches["aggregate"]
    got = agg_ops.aggregate_trees(trees, w)
    assert agg_ops.launches["aggregate"] == before + 1
    want = unflatten_params(aggregate_flat(torch.stack([flatten_params(t) for t in trees]), w), like)
    assert all(torch.equal(got[key], want[key]) for key in like)


@pytest.mark.parametrize("measure", ["arccos", "l1"])
def test_chunked_host_g_launches_once_a_slab(cuda, measure):
    """A host numpy G goes to the card a slab at a time: one B1 launch a
    slab, the distances on the card within 1e-4 of the one-shot op's."""
    G = (1e-3 * np.random.default_rng(5).normal(size=(40, 20_000))).astype(np.float32)
    before = sum(ops.launches.values())
    got = ops.pairwise_distances_chunked(G, measure, d_chunk=6000)
    assert sum(ops.launches.values()) == before + 4 and got.device.type == "cuda"
    want = ops.pairwise_distances_device(torch.from_numpy(G).to(cuda), measure)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
