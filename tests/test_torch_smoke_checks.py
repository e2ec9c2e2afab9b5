"""The kernel checks of ``chip_smoke.py``, held against wrong answers on the CPU.

The smoke run holds the CUDA Gram kernel against its plain version with a
tolerance relative to ‖g_i‖·‖g_j‖. These tests show that the check accepts
the kernels' order (``ops.split_plan``'s d-splits of 32-column chunks,
summed in groups of 8, then the groups in order) and the exact sum, and
rejects a kernel that drops the ragged d tail (the last ``d mod 32``
columns, the kernel's d-chunk), halves every entry, drops one group sum,
counts one twice or shifts the splits' k-ranges by a chunk, at each shape
the smoke run checks. The SRP check,
relative to ‖x_i‖·‖S_:,j‖, gets the same treatment: it accepts the kernels'
order (128 d-splits summed in groups of 8, then the groups in order) and
the exact sum, and rejects a kernel that drops the ragged d tail
(``d mod 512``, the plain version's block, or ``d mod 64``, the kernel's
k-tile), reads the signs of the next row of k, drops one group sum, counts
one twice (a stale ticket) or shifts the splits' k-ranges by a tile. The flash-attention check
(atol 2e-5 in f32; in bf16 relative to the softmax-weighted |v|) accepts
the kernels' own order of work, an online softmax over 64-key tiles with p
rounded against the running max (exp in the f32 kernel, exp2 of scores
scaled by hd^-½·log₂e in the bf16 one), and rejects a kernel that drops
the last partial k-tile or ignores the causal mask, and a bf16 kernel that
leaves garbage in the head-dim pad columns of Q and K or shifts the
diagonal by one key: a check must fail the kernels it exists to catch.
The aggregate check (rtol = atol 2e-5) accepts the kernel's ascending FMA
chain and rejects a kernel that drops the θ^t row, the last column or
pairs each row with the next row's weight; the build's SASS count of row
loads before the first FFMA is read from the right kernel and opcodes. The
kernels-a-call check profiles another window only when the profiler kept
fewer events than launched, and fails at once on a launch too many or
another kernel beside the expected ones.
"""
import functools
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.clustering.similarity import pairwise_distances
from repro_torch.kernels.similarity import ops
from repro_torch.kernels.similarity.ref import gram_ref
from repro_torch.kernels.sketch import ops as sk_ops
from repro_torch.kernels.sketch.ref import sketch_srp_plain, srp_sign_block
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _G(n, d):
    rng = np.random.default_rng(0)
    return torch.from_numpy((smoke.SIM_SCALE * rng.normal(size=(n, d))).astype(np.float32))


def _split_gram(G, wrong=None):
    """G Gᵀ as the CUDA kernels sum it: an f32 partial per d-split of
    ``ops.BK``-wide chunks (``ops.split_plan``); the partials of each group
    of ``ops.GROUP`` splits added in split order (the last group may hold
    fewer), then the group sums in group order; one split is the sum
    itself. ``wrong`` names a fault of that reduction: ``"drop_group"``
    leaves one group sum out, ``"group_twice"`` adds one twice,
    ``"k_off_by_one_chunk"`` shifts every split's k-range by one chunk."""
    d = G.shape[1]
    splits, per = ops.split_plan(*G.shape)
    shift = ops.BK if wrong == "k_off_by_one_chunk" else 0
    parts = []
    for s in range(splits):
        part = G[:, min(d, s * per * ops.BK + shift):min(d, (s + 1) * per * ops.BK + shift)]
        parts.append(part @ part.T)
    groups = []
    for q in range(0, splits, ops.GROUP):
        acc = parts[q]
        for p in parts[q + 1:q + ops.GROUP]:
            acc = acc + p
        groups.append(acc)
    if wrong == "drop_group":
        groups[0] = torch.zeros_like(groups[0])
    elif wrong == "group_twice":
        groups.insert(0, groups[0])
    out = groups[0]
    for g in groups[1:]:
        out = out + g
    return out


@pytest.mark.parametrize("n,d", smoke.SIM_SHAPES)
def test_gram_check_accepts_other_f32_orders(n, d):
    G = _G(n, d)
    want = gram_ref(G)
    exact = (G.double() @ G.double().T).float()
    assert smoke.gram_rel_err(_split_gram(G), want, G) <= smoke.GRAM_RTOL
    assert smoke.gram_rel_err(exact, want, G) <= smoke.GRAM_RTOL


@pytest.mark.parametrize("wrong", ["drop_group", "group_twice", "k_off_by_one_chunk"])
@pytest.mark.parametrize("n,d", smoke.SIM_SHAPES)
def test_gram_check_rejects_wrong_reductions(n, d, wrong):
    G = _G(n, d)
    got = _split_gram(G, wrong)
    assert smoke.gram_rel_err(got, gram_ref(G), G) > smoke.GRAM_RTOL


@pytest.mark.parametrize("wrong", ["drop_tail", "halve"])
@pytest.mark.parametrize("n,d", smoke.SIM_SHAPES)
def test_gram_check_rejects_wrong_kernels(n, d, wrong):
    G = _G(n, d)
    want = gram_ref(G)
    if wrong == "drop_tail":
        tail = d % ops.BK
        assert tail > 0, "every checked shape has a ragged d tail"
        got = gram_ref(G[:, : d - tail].contiguous())
    else:
        got = 0.5 * want
    assert smoke.gram_rel_err(got, want, G) > smoke.GRAM_RTOL


@pytest.mark.parametrize("measure", ["arccos", "l2", "l1"])
@pytest.mark.parametrize("n,d", [(13, 101), (20, 300)])
def test_cpu_ops_match_f64_definitions(measure, n, d):
    """The port's CPU path against the f64 numpy measure definitions."""
    G = (1e-2 * np.random.default_rng(5).normal(size=(n, d))).astype(np.float32)
    G[[2, 6]] = 0.0  # never-sampled clients
    got = ops.make_distance_fn()(torch.from_numpy(G), measure)
    np.testing.assert_allclose(got, pairwise_distances(G, measure), atol=1e-4)


def _X(c, d):
    rng = np.random.default_rng(1)
    return torch.from_numpy((smoke.SIM_SCALE * rng.normal(size=(c, d))).astype(np.float32))


def _split_srp(X, d_prime, seed, wrong=None):
    """X·S as the CUDA kernels sum it: an f32 partial per d-split of 64-wide
    k-tiles; the partials of each group of 8 splits added in split order,
    then the group sums in group order. ``wrong`` names a fault of that
    reduction: ``"drop_group"`` leaves one group sum out, ``"group_twice"``
    adds one twice (as a stale ticket would in a one-launch version),
    ``"k_off_by_one_tile"`` shifts every split's k-range by one tile."""
    d = X.shape[1]
    splits, per = sk_ops.split_plan(d)
    S = srp_sign_block(seed, 0, d, d_prime, d, device="cpu")
    shift = sk_ops.TK if wrong == "k_off_by_one_tile" else 0
    parts = []
    for s in range(splits):
        lo, hi = min(d, s * per * sk_ops.TK + shift), min(d, (s + 1) * per * sk_ops.TK + shift)
        parts.append(X[:, lo:hi] @ S[lo:hi])
    groups = []
    for q in range(0, splits, sk_ops.GROUP):
        acc = parts[q]
        for r in range(1, sk_ops.GROUP):
            acc = acc + parts[q + r]
        groups.append(acc)
    if wrong == "drop_group":
        groups[0] = torch.zeros_like(groups[0])
    elif wrong == "group_twice":
        groups.insert(0, groups[0])
    out = groups[0]
    for part in groups[1:]:
        out = out + part
    return out


@pytest.mark.parametrize("c,d,d_prime", smoke.SRP_SHAPES)
def test_srp_check_accepts_other_f32_orders(c, d, d_prime):
    X = _X(c, d)
    want = sketch_srp_plain(X, d_prime, smoke.SRP_SEED)
    S = srp_sign_block(smoke.SRP_SEED, 0, d, d_prime, d, device="cpu")
    exact = (X.double() @ S.double()).float()
    assert smoke.srp_rel_err(_split_srp(X, d_prime, smoke.SRP_SEED), want, X, d_prime) <= smoke.SRP_RTOL
    assert smoke.srp_rel_err(exact, want, X, d_prime) <= smoke.SRP_RTOL


@pytest.mark.parametrize(
    "wrong",
    ["drop_tail_512", "drop_tail_64", "signs_off_by_one_row", "drop_group", "group_twice",
     "k_off_by_one_tile"],
)
@pytest.mark.parametrize("c,d,d_prime", smoke.SRP_SHAPES)
def test_srp_check_rejects_wrong_kernels(c, d, d_prime, wrong):
    X = _X(c, d)
    want = sketch_srp_plain(X, d_prime, smoke.SRP_SEED)
    S = srp_sign_block(smoke.SRP_SEED, 0, d, d_prime, d, device="cpu")
    if wrong.startswith("drop_tail"):
        tail = d % int(wrong.rsplit("_", 1)[1])
        assert tail > 0, "every checked shape has a ragged d tail"
        got = X[:, : d - tail] @ S[: d - tail]
    elif wrong == "signs_off_by_one_row":
        got = X @ srp_sign_block(smoke.SRP_SEED, 1, d, d_prime, d + 1, device="cpu")
    else:
        got = _split_srp(X, d_prime, smoke.SRP_SEED, wrong)
    assert smoke.srp_rel_err(got, want, X, d_prime) > smoke.SRP_RTOL


LOG2E = 1.4426950408889634
MASKS = {"j<=i": 0, "j<=i+1": 1, "j<i": -1}  # the causal mask, right and shifted


def _flash_online(q, k, v, bk=64, drop_last_partial=False, causal=True, exp2=False,
                  pad=None, mask="j<=i"):
    """The CUDA kernels' order of work in torch: 64-key tiles in order, the
    running max, p rounded to v's dtype against it, the denominator summed
    from the unrounded p, f32 sums; with ``exp2`` the bf16 kernel's exp2 of
    scores scaled by hd^-½·log₂e, and with ``pad="zeros"`` its Q and K
    zero-filled up to its padded head dim (32, 64 or 128). The broken
    variants drop the last partial k-tile or the causal mask, leave garbage
    in those pad columns (``pad="garbage"``), or shift the causal mask by
    one key (``mask``)."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf, kf = q.float(), k.float()
    if pad is not None:
        width = next(p for p in (32, 64, 128) if hd <= p) - hd
        gen = torch.Generator().manual_seed(3)
        fill = torch.zeros if pad == "zeros" else functools.partial(torch.randn, generator=gen)
        qf, kf = (torch.cat([a, fill(a.shape[:3] + (width,)).to(q.dtype).float()], dim=-1)
                  for a in (qf, kf))
    qf = qf.reshape(b, s, kv, g, qf.shape[-1])
    scale = hd**-0.5 * (LOG2E if exp2 else 1.0)
    exp = torch.exp2 if exp2 else torch.exp
    m = torch.full((b, kv, g, s, 1), -1e30)
    l = torch.zeros((b, kv, g, s, 1))
    acc = torch.zeros((b, kv, g, s, hd))
    rows = torch.arange(s)[:, None] + MASKS[mask]
    end = t - (t % bk) if drop_last_partial and t % bk else t
    for k0 in range(0, end, bk):
        kt, vt = kf[:, k0:k0 + bk], v[:, k0:k0 + bk]
        sc = torch.einsum("bskgh,btkh->bkgst", qf, kt) * scale
        if causal:
            sc = torch.where(k0 + torch.arange(kt.shape[1])[None, :] <= rows, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = exp(sc - m_new)
        alpha = exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkh->bkgsh", p.to(v.dtype).float(), vt.float())
        m = m_new
    out = (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return out.to(q.dtype)


FLASH_CASES = ([(shape, torch.float32) for shape in smoke.FLASH_F32_SHAPES]
               + [(shape, torch.bfloat16) for shape in smoke.FLASH_BF16_SHAPES])


def _qkv(b, s, h, kv, hd, dtype):
    rng = np.random.default_rng(2)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


@pytest.mark.parametrize("shape,dtype", FLASH_CASES)
def test_flash_check_accepts_the_kernels_order(shape, dtype):
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _qkv(*shape, dtype)
    want = flash_attention_plain(q, k, v)
    got = _flash_online(q, k, v, exp2=dtype == torch.bfloat16)
    assert smoke.flash_excess(got, want, q, k, v) <= 1.0


# a partial last tile to drop and, past S = 1, keys for the causal mask to hide
@pytest.mark.parametrize("wrong", ["drop_last_partial_tile", "no_causal_mask"])
@pytest.mark.parametrize("shape,dtype", [c for c in FLASH_CASES if c[0][1] % 64 and c[0][1] > 1])
def test_flash_check_rejects_wrong_kernels(shape, dtype, wrong):
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _qkv(*shape, dtype)
    want = flash_attention_plain(q, k, v)
    exp2 = dtype == torch.bfloat16
    if wrong == "drop_last_partial_tile":
        got = _flash_online(q, k, v, drop_last_partial=True, exp2=exp2)
    else:
        got = _flash_online(q, k, v, causal=False, exp2=exp2)
    assert smoke.flash_excess(got, want, q, k, v) > 1.0


# the widened domain's checks: head dims 12 to 320 in f32 and bf16, f16
FLASH_WIDE_CASES = ([((*smoke.FLASH_WIDE, hd), dtype) for hd in smoke.FLASH_WIDE_HDS
                     for dtype in (torch.float32, torch.bfloat16)]
                    + [(shape, torch.float16) for shape in smoke.FLASH_F16_SHAPES])


@pytest.mark.parametrize("shape,dtype", FLASH_WIDE_CASES)
def test_flash_check_accepts_the_kernels_order_in_the_widened_domain(shape, dtype):
    """f32's exp, and the 16-bit kernels' exp2 with p rounded to f16 or bf16
    against the running max: within the f16 limit (2⁻¹⁰) as the bf16 order
    is within 2⁻⁷."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _qkv(*shape, dtype)
    want = flash_attention_plain(q, k, v)
    got = _flash_online(q, k, v, exp2=dtype != torch.float32)
    assert smoke.flash_excess(got, want, q, k, v) <= 1.0


@pytest.mark.parametrize("wrong", ["drop_last_partial_tile", "no_causal_mask"])
@pytest.mark.parametrize("shape", smoke.FLASH_F16_SHAPES)
def test_flash_check_rejects_wrong_f16_kernels(shape, wrong):
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _qkv(*shape, torch.float16)
    want = flash_attention_plain(q, k, v)
    got = _flash_online(q, k, v, exp2=True, drop_last_partial=wrong == "drop_last_partial_tile",
                        causal=wrong != "no_causal_mask")
    assert smoke.flash_excess(got, want, q, k, v) > 1.0


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_113flash_fwd_mmaILi128EEEvPKtS3_S3_Pt", "flash_fwd_mma<128>"),
    # nvcc --split-compile names the anonymous namespace after the file
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_2c13897913flash_fwd_mmaI6__halfLi256EEEvPKt",
     "flash_fwd_mma<__half,256>"),
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_2c13897918flash_fwd_mma_wideI13__nv_bfloat16EEvPKt",
     "flash_fwd_mma_wide<__nv_bfloat16>"),
    ("void (anonymous namespace)::flash_fwd_mma<__nv_bfloat16, 128>(unsigned short const*, int)",
     "flash_fwd_mma<__nv_bfloat16,128>"),
    # the f32 route's instances: builtin f, named types, a repeated type (S1_)
    ("_ZN12_GLOBAL__N_113flash_fwd_f32IffEEvPKfS2_PKT_PT0_iiiiiii", "flash_fwd_f32<float,float>"),
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_2c13897913flash_fwd_f32If6__halfEEvPKfS3_",
     "flash_fwd_f32<float,__half>"),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32I13__nv_bfloat16fEEvPKfS3_", "flash_fwd_f32<__nv_bfloat16,float>"),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32I6__halfS1_EEvPKfS3_PKT_PT0_", "flash_fwd_f32<__half,__half>"),
    ("void (anonymous namespace)::flash_fwd_f32<float, __half>(float const*, float const*, int)",
     "flash_fwd_f32<float,__half>"),
])
def test_kernel_name_reads_type_and_integer_template_arguments(mangled, name):
    """The flash kernels' names in ptxas reports, cuobjdump and profiler
    traces, mangled or demangled, with their element type and head dim."""
    assert smoke._kernel_name(mangled) == name


HD8 = next(shape for shape in smoke.FLASH_BF16_SHAPES if shape[-1] == 8)
HD72 = next(shape for shape in smoke.FLASH_BF16_SHAPES if shape[-1] == 72)


@pytest.mark.parametrize("shape", [smoke.FLASH_PATH, HD8])
def test_flash_check_accepts_the_bf16_kernels_zero_padded_order(shape):
    """The bf16 kernel's order with Q and K zero-filled up to its padded
    head dim: the check passes it."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _qkv(*shape, torch.bfloat16)
    want = flash_attention_plain(q, k, v)
    got = _flash_online(q, k, v, exp2=True, pad="zeros")
    assert smoke.flash_excess(got, want, q, k, v) <= 1.0


@pytest.mark.parametrize("wrong,shape", [
    ("pad_garbage", HD8), ("pad_garbage", HD72), ("pad_garbage", (1, 32, 4, 2, 16)),
    ("mask_j<=i+1", HD8), ("mask_j<=i+1", smoke.FLASH_PATH),
    ("mask_j<i", HD8), ("mask_j<i", smoke.FLASH_PATH),
])
def test_flash_check_rejects_wrong_bf16_kernels(wrong, shape):
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _qkv(*shape, torch.bfloat16)
    want = flash_attention_plain(q, k, v)
    if wrong == "pad_garbage":
        got = _flash_online(q, k, v, exp2=True, pad="garbage")
    else:
        got = _flash_online(q, k, v, exp2=True, mask=wrong.removeprefix("mask_"))
    assert smoke.flash_excess(got, want, q, k, v) > 1.0


def _fma_chain(U, w, wrong=None):
    """Σ_r w[r]·U[r] as csrc/aggregate.cu sums it: fmaf(w[r], U[r, j], acc)
    from acc = 0, rows ascending (each fmaf taken in f64, one rounding to
    f32). ``wrong``: ``"drop_last_row"`` leaves the θ^t row out,
    ``"drop_last_column"`` leaves the last output 0, ``"weights_off_by_one"``
    pairs row r with w[r + 1]."""
    U64, w64 = U.double(), w.double()
    if wrong == "weights_off_by_one":
        w64 = torch.roll(w64, -1)
    rows = U.shape[0] - (wrong == "drop_last_row")
    acc = torch.zeros(U.shape[1], dtype=torch.float32)
    for r in range(rows):
        acc = (w64[r] * U64[r] + acc.double()).float()
    if wrong == "drop_last_column":
        acc[-1] = 0.0
    return acc


def _agg_inputs(k, p):
    rng = np.random.default_rng(1)
    return (torch.from_numpy(rng.normal(size=(k, p)).astype(np.float32)),
            torch.from_numpy(rng.random(k).astype(np.float32)))


def _agg_check(got, want):
    return torch.allclose(got, want, rtol=smoke.AGG_TOL, atol=smoke.AGG_TOL)


@pytest.mark.parametrize("k,p", smoke.AGG_SHAPES)
def test_aggregate_check_accepts_the_kernels_order(k, p):
    from repro_torch.kernels.aggregate.ref import aggregate_ref

    U, w = _agg_inputs(k, p)
    assert _agg_check(_fma_chain(U, w), aggregate_ref(U, w))


@pytest.mark.parametrize("wrong", ["drop_last_row", "drop_last_column", "weights_off_by_one"])
@pytest.mark.parametrize("k,p", smoke.AGG_SHAPES)
def test_aggregate_check_rejects_wrong_kernels(k, p, wrong):
    from repro_torch.kernels.aggregate.ref import aggregate_ref

    U, w = _agg_inputs(k, p)
    assert not _agg_check(_fma_chain(U, w, wrong), aggregate_ref(U, w))


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_114aggregate_vec2EPKNS_4ColsEPKfPS0_ii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.64.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.CONSTANT R6, desc[UR4][R8.64] ;
        /*0030*/                   LDGSTS.E.128 [R12], desc[UR4][R2.64] ;
        /*0040*/                   LDG.E.64.CONSTANT R14, desc[UR4][R2.64+0x10] ;
        /*0050*/                   FFMA R10, R6, R4, RZ ;
        /*0060*/                   LDG.E.64.CONSTANT R4, desc[UR4][R2.64+0x20] ;
        /*0070*/                   FFMA R10, R6, R14, R10 ;
                Function : _ZN12_GLOBAL__N_116aggregate_scalarEPKfS1_Pfii
        /*0000*/                   FFMA R10, R6, R4, RZ ;
        /*0010*/                   LDG.E.CONSTANT R6, desc[UR4][R8.64] ;
"""


def test_sass_loads_ahead_counts_row_loads_before_the_first_ffma(monkeypatch):
    import shutil
    import subprocess
    import sys
    from types import SimpleNamespace

    monkeypatch.setattr(shutil, "which", lambda tool: sys.executable)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: SimpleNamespace(stdout=SASS))
    assert smoke.sass_loads_ahead("lib.so") == {"aggregate_vec2": [3, 2, 4, 2],
                                                "aggregate_scalar": [0, 0, 1, 1]}
    assert smoke.sass_counts("lib.so", ("FFMA", "LDGSTS")) == {
        "aggregate_vec2": {"FFMA": 2, "LDGSTS": 1}, "aggregate_scalar": {"FFMA": 1, "LDGSTS": 0}}


AGG_EVENT = "_ZN12_GLOBAL__N_114aggregate_vec2EPKfS1_Pfii"


@pytest.mark.parametrize("windows,passes,profiled", [
    ([20], True, 1),
    ([18], True, 1),  # the profiler dropped 2: accepted
    ([7, 20], True, 2),  # it dropped 13: profiled again
    ([0, 0, 0, 0, 19], True, 5),
    ([0, 0, 0, 0, 0], False, 5),  # never a full window: the kernel did not run a call
    ([21, 20], False, 1),  # a launch too many: fails at once, drops cannot add events
    (["other", 20], False, 1),  # a copy or a fill beside the kernel: fails at once
])
def test_kernels_a_call_profiles_again_only_when_events_were_dropped(monkeypatch, windows,
                                                                     passes, profiled):
    from types import SimpleNamespace

    def window(w):
        if w == "other":
            return [SimpleNamespace(name=AGG_EVENT)] * 20 + [SimpleNamespace(name="fill_kernel")]
        return [SimpleNamespace(name=AGG_EVENT)] * w

    seen = iter(windows)
    calls = []
    monkeypatch.setattr(smoke, "device_events",
                        lambda torch_, fn, reps: calls.append(reps) or window(next(seen)))
    if passes:
        smoke.kernels_a_call(torch, "aggregate", lambda: None, ("aggregate_",))
    else:
        with pytest.raises(RuntimeError, match="expected each of"):
            smoke.kernels_a_call(torch, "aggregate", lambda: None, ("aggregate_",))
    assert calls == [20] * profiled


# mixed dtypes: the f32 kernel's order (exp, 64-key tiles) with p rounded to
# v's dtype, held at the lowest precision's limit among q, k and v
MIXED = [c for c in itertools.product((torch.float32, torch.bfloat16, torch.float16), repeat=3)
         if len(set(c)) > 1]


def _mixed_qkv(shape, dtypes):
    return tuple(a.float().to(d) for a, d in zip(_qkv(*shape, torch.float32), dtypes))


@pytest.mark.parametrize("dtypes", MIXED, ids=str)
def test_flash_check_accepts_the_mixed_route_order(dtypes):
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _mixed_qkv(smoke.FLASH_MIXED_SHAPE, dtypes)
    want = flash_attention_plain(q, k, v)
    assert smoke.flash_excess(_flash_online(q, k, v), want, q, k, v) <= 1.0


@pytest.mark.parametrize("wrong", ["drop_last_partial_tile", "no_causal_mask"])
@pytest.mark.parametrize("dtypes", MIXED[::5], ids=str)
def test_flash_check_rejects_wrong_mixed_kernels(dtypes, wrong):
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _mixed_qkv((1, 130, 4, 2, 16), dtypes)
    want = flash_attention_plain(q, k, v)
    got = _flash_online(q, k, v, drop_last_partial=wrong == "drop_last_partial_tile",
                        causal=wrong != "no_causal_mask")
    assert smoke.flash_excess(got, want, q, k, v) > 1.0


@pytest.mark.parametrize("rounds_p", [True, False])
@pytest.mark.parametrize("dtypes", [d for d in MIXED if d[0] == torch.float32 and d[2] != torch.float32],
                         ids=str)
def test_p_rounding_check_tells_a_route_that_widens_v(dtypes, rounds_p):
    """Within the limit a route that widens v without rounding p passes the
    error check, so the smoke also compares means at one k-tile: the
    kernel's order with p rounded passes, the unrounded form fails."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v = _mixed_qkv(smoke.FLASH_MIXED_SHAPE, dtypes)
    got = _flash_online(q, k, v if rounds_p else v.float()).to(q.dtype)
    assert smoke.flash_excess(got, flash_attention_plain(q, k, v), q, k, v) <= 1.0
    rounded, unrounded = smoke.flash_p_rounding(got, q, k, v)
    assert (rounded * smoke.FLASH_P_ROUNDING < unrounded) == rounds_p


def test_flash_lowest_and_bound_read_each_operand():
    q, k, v = _mixed_qkv((1, 8, 4, 2, 16), (torch.float32, torch.float16, torch.bfloat16))
    assert smoke.flash_lowest(q, k, v) == "bfloat16"
    assert smoke.flash_lowest(q, k) == "float16" and smoke.flash_lowest(q) == "float32"
    bound, by, flops, nbytes = smoke.flash_bound("NVIDIA H100 80GB HBM3", q, k, v)
    assert nbytes == 2 * 4 * 8 * 4 * 16 + (2 + 2) * 8 * 2 * 16  # q and out f32, k f16, v bf16
    assert flops == 2 * 4 * 8 * 8 * 16  # the causal half of QKᵀ and PV
    want_ops = (flops / 2 / 67e12 + flops / 2 / 989e12) * 1e3  # f32 × f16 QKᵀ; bf16 PV
    assert by == "bytes" and bound == pytest.approx(max(nbytes / 3.35e12 * 1e3, want_ops))
