"""The port's similarity ops against the JAX reference (Pallas interpret mode)."""
import numpy as np
import pytest
import torch

from repro.kernels.similarity.ops import make_distance_fn as ref_make_distance_fn
from repro_torch.kernels.similarity import ops
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

MEASURES = ["arccos", "l2", "l1"]
# (13, 101) is the ragged tier-1 gate; (12, 8300) has d > STREAM_D_THRESHOLD,
# so both packages take their streamed entry point.
SHAPES = [(13, 101), (20, 300), (12, 8300)]


def _G(n, d, seed=0):
    # update scale: G rows are θ_i − θ after lr-scaled SGD steps. At unit
    # scale an f32 L1 sum over 8300 coordinates is ~9e3, whose ulp (~1e-3)
    # alone exceeds the 1e-4 tolerance.
    return (1e-2 * np.random.default_rng(seed).normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("measure", MEASURES)
def test_distances_match_reference(measure, n, d):
    G = _G(n, d)
    want = ref_make_distance_fn(interpret=True)(G, measure)
    got = ops.make_distance_fn()(torch.from_numpy(G), measure)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (np.diag(got) == 0).all()
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("entry", ["device", "streamed"])
@pytest.mark.parametrize("measure", MEASURES)
def test_both_entry_points_agree(measure, entry):
    G = torch.from_numpy(_G(13, 101, seed=1))
    fn = getattr(ops, f"pairwise_distances_{entry}")
    want = ref_make_distance_fn(interpret=True)(G.numpy(), measure)
    np.testing.assert_allclose(fn(G, measure).numpy(), want, atol=1e-4)


@pytest.mark.parametrize("measure", MEASURES)
def test_zero_rows(measure):
    """Never-sampled clients: zero-vs-zero is 0 and, under arccos,
    zero-vs-nonzero is π/2 (``tests/test_kernels.py:52,70``)."""
    G = _G(9, 24, seed=2)
    G[[0, 3, 7]] = 0.0
    want = ref_make_distance_fn(interpret=True)(G, measure)
    got = ops.pairwise_distances_device(torch.from_numpy(G), measure).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[0, 3] == 0.0 and got[3, 7] == 0.0
    if measure == "arccos":
        np.testing.assert_allclose(got[0, 1], np.pi / 2, atol=1e-6)
        np.testing.assert_allclose(got[7, 2], np.pi / 2, atol=1e-6)


def test_split_plan_covers_d():
    for n, d in [(13, 101), (100, 39760), (100, 64), (257, 8193), (1, 1), (17, 1001), (3, 10**6)]:
        splits, per = ops.split_plan(n, d)
        n_chunks = -(-d // ops.BK)
        # every split holds a chunk and the splits cover d
        assert splits * per >= n_chunks > (splits - 1) * per
        assert 1 <= splits <= ops.MAX_SPLITS
        assert splits == 1 or per >= ops.MIN_CHUNKS
    # the main path's store: one split and one launch; at model width, 249
    # splits of 5 chunks, added in 32 groups
    assert ops.split_plan(100, 64) == (1, 2)
    assert ops.split_plan(100, 39760) == (249, 5)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        ops.pairwise_sums(torch.zeros(3, 4, dtype=torch.float64), "gram")
    with pytest.raises(ValueError):
        ops.pairwise_sums(torch.zeros(3, 4), "cosine")
    # meta inputs (the dry-run's) give the output's shape and no data
    out = ops.pairwise_sums(torch.zeros(3, 4, device="meta"), "gram")
    assert out.device.type == "meta" and out.shape == (3, 3) and out.dtype == torch.float32
