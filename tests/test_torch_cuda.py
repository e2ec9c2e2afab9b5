"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests import no JAX, so they run on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA GPU every test here skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.aggregate.ops import aggregate_flat
from repro_torch.kernels.aggregate.ref import aggregate_ref
from repro_torch.kernels.similarity import ops
from repro_torch.kernels.similarity.ref import gram_ref, l1_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d", [(13, 101), (100, 39760), (257, 8193), (1, 1)])
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


@pytest.mark.parametrize("k,p", [(11, 39760), (3, 1001), (1, 1)])
def test_aggregate_kernel_matches_plain(cuda, k, p):
    rng = np.random.default_rng(4)
    U = torch.from_numpy(rng.normal(size=(k, p)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(k,)).astype(np.float32)).to(cuda)
    got = aggregate_flat(U, w)
    want = aggregate_ref(U, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)


def test_launch_counters_count_kernel_launches(cuda):
    G = torch.ones((4, 8), device=cuda)
    before = dict(ops.launches)
    ops.pairwise_distances_device(G, "arccos")
    ops.pairwise_distances_streamed(G, "l1")
    assert ops.launches["gram"] == before["gram"] + 1
    assert ops.launches["l1"] == before["l1"] + 1
