"""The port's device clusterers against the JAX package's, on the CPU."""
import numpy as np
import pytest
import torch

from repro.core.clustering import backends as ref_backends
from repro.core.clustering.device import kmeans_labels as ref_kmeans_labels
from repro.core.clustering.device import ward_linkage_device as ref_ward_device
from repro.core.clustering.similarity import pairwise_distances
from repro.core.clustering.ward import ward_linkage as ref_ward
from repro.kernels.similarity.ops import make_distance_fn as ref_make_distance_fn
from repro_torch.core.clustering import backends
from repro_torch.core.clustering.device import kmeans_labels, ward_linkage_device
from repro_torch.kernels.similarity.ops import make_distance_fn
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


@pytest.mark.parametrize("n,d,seed", [(2, 3, 0), (17, 5, 1), (60, 8, 2)])
def test_ward_device_merge_order_exact_on_distinct_distances(n, d, seed):
    X = np.random.default_rng(seed).normal(size=(n, d))
    dist = pairwise_distances(X, "l2")
    got = ward_linkage_device(torch.from_numpy(dist))
    for want in (ref_ward(dist), ref_ward_device(dist)):
        np.testing.assert_array_equal(got[:, [0, 1, 3]], want[:, [0, 1, 3]])
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-4, atol=1e-6)


def test_ward_device_takes_numpy_and_rejects_non_square():
    dist = pairwise_distances(np.random.default_rng(0).normal(size=(5, 3)), "l2")
    np.testing.assert_array_equal(ward_linkage_device(dist), ward_linkage_device(torch.from_numpy(dist)))
    assert ward_linkage_device(np.zeros((1, 1))).shape == (0, 4)
    with pytest.raises(ValueError, match="square"):
        ward_linkage_device(np.zeros((3, 4)))


def _clustered_rows(n, d, n_centers, seed, zero_rows=()):
    """(n, d) f32 at update scale: noisy copies of a few directions, plus
    zero rows for never-sampled clients."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d))
    G = 1e-2 * (centers[rng.integers(0, n_centers, size=n)] + 0.3 * rng.normal(size=(n, d)))
    G[list(zero_rows)] = 0.0
    return G.astype(np.float32)


def _kmeans_inputs():
    """(G, k, seed) cases: the inputs of tests/test_clustering.py's k-means
    tests, and clustered rows at the fleet phase's sketch width.

    In "zero_rows" the zero rows 2, 7, 12, 17 include the initial centroid
    2, so every zero row is at distance exactly 0 from a zero centroid and
    the assignment is exact; the case without a zero initial centroid is
    :func:`test_kmeans_zero_rows_tied_between_centroids`.
    """
    plain = np.random.default_rng(0).normal(size=(50, 8)).astype(np.float32)
    zeros = np.random.default_rng(1).normal(size=(20, 6)).astype(np.float32)
    zeros[2::5] = 0.0
    assert 2 in np.random.default_rng(0).permutation(20)[:4]
    return {
        "random": (plain, 5, 7),
        "zero_rows": (zeros, 4, 0),
        "clustered_d64": (_clustered_rows(200, 64, 8, seed=1, zero_rows=range(0, 200, 3)), 20, 1),
    }


@pytest.mark.parametrize("measure", ["arccos", "l2"])
@pytest.mark.parametrize("case", ["random", "zero_rows", "clustered_d64"])
def test_kmeans_labels_equal_reference(case, measure):
    G, k, seed = _kmeans_inputs()[case]
    want = ref_kmeans_labels(G, k, measure=measure, seed=seed)
    got = kmeans_labels(torch.from_numpy(G), k, measure=measure, seed=seed)
    np.testing.assert_array_equal(got, want)
    zero = np.flatnonzero(~G.any(axis=1))
    if zero.size and measure == "arccos":
        assert len(set(got[zero].tolist())) == 1  # cold-start rows share a cluster


def test_kmeans_zero_rows_tied_between_centroids():
    """tests/test_clustering.py's zero-row input: rows 0, 5, 10, 15 are zero
    and none of the initial centroids 4, 19, 6, 2 is. Under arccos a zero
    row is then at |c|² = 1 from every unit-norm initial centroid, and that
    exact tie is broken by the rounding of the norms: the reference's label
    depends on XLA's f32 summation order, the port's on its own
    (``device._row_sumsq``, the same bits on the CPU and the card). Both
    keep the zero rows in one cluster."""
    G = np.random.default_rng(1).normal(size=(20, 6)).astype(np.float32)
    G[::5] = 0.0
    assert not set(np.random.default_rng(0).permutation(20)[:4].tolist()) & {0, 5, 10, 15}
    for labels in (ref_kmeans_labels(G, 4, seed=0), kmeans_labels(torch.from_numpy(G), 4, seed=0)):
        assert len(set(labels[::5].tolist())) == 1
    got = kmeans_labels(torch.from_numpy(G), 4, seed=0)
    np.testing.assert_array_equal(got, kmeans_labels(torch.from_numpy(G), 4, seed=0))


def test_kmeans_rejects_bad_k():
    with pytest.raises(ValueError, match="1 <= k <= n"):
        kmeans_labels(torch.zeros((3, 2)), 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_groups_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n, m = 40, 6
    labels = rng.integers(0, 4, size=n)
    mass = rng.integers(1, 30, size=n) * m
    cap = int(mass.sum() // m)
    got = backends._capacity_groups(labels, mass, m, cap)
    want = ref_backends._capacity_groups(labels, mass, m, cap)
    assert [g.tolist() for g in got] == [g.tolist() for g in want]


def test_capacity_groups_rejects_oversized_client():
    with pytest.raises(ValueError, match="dedicated"):
        backends._capacity_groups(np.zeros(3, int), np.array([5, 50, 5]), 2, 20)


@pytest.mark.parametrize("name", ["kmeans", "ward_jit"])
@pytest.mark.parametrize("measure", ["arccos", "l2", "l1"])
def test_clusterer_partitions_equal_reference(name, measure):
    # zero rows 3, 10, 17, 24: row 3 is one of k-means' initial centroids
    G = _clustered_rows(30, 16, 4, seed=4, zero_rows=range(3, 30, 7))
    assert 3 in np.random.default_rng(3).permutation(30)[:5]
    mass = np.random.default_rng(4).integers(1, 20, size=30) * 5
    cap = int(mass.sum() // 5)
    want = ref_backends.CLUSTERERS.get(name)(G, mass, 5, cap, measure=measure, seed=3,
                                             distance_fn=ref_make_distance_fn(interpret=True))
    got = backends.CLUSTERERS.get(name)(torch.from_numpy(G), mass, 5, cap, measure=measure, seed=3,
                                        distance_fn=make_distance_fn())
    assert [g.tolist() for g in got] == [g.tolist() for g in want]


def test_registry_names_match_reference():
    assert backends.CLUSTERERS.names() == ref_backends.CLUSTERERS.names()
