"""The port's Algorithm 2 plans against the JAX reference's, token for token."""
import numpy as np
import pytest
import torch

from repro.core.samplers.algorithm2 import build_plan_algorithm2 as ref_build
from repro.fl.partition import by_class_shards as ref_by_class_shards
from repro.fl.partition import dirichlet_labels as ref_dirichlet_labels
from repro.kernels.similarity.ops import resolve_distance_backend as ref_backend
from repro_torch.core.samplers.algorithm2 import build_plan_algorithm2
from repro_torch.fl.partition import by_class_shards, dirichlet_labels
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

M = 5
SHARDS = dict(n_classes=10, clients_per_class=2, train_per_client=30, test_per_client=5, dim=16, seed=0)
# client 0 holds a third of the data, so p_0 >= 1/m and it gets a dedicated urn
DIRICHLET = dict(alpha=0.1, size_profile=((1, 300), (15, 40)), dim=16, seed=0)
def representative_gradients(dataset, d: int = 300, zero_rows=(), seed: int = 0):
    """(n, d) f32 stand-in for Algorithm 2's G at update scale.

    Row i is client i's mean feature vector through a fixed random
    projection, scaled to the size of an SGD update, plus noise; rows in
    ``zero_rows`` stay 0 as for never-sampled clients.
    """
    rng = np.random.default_rng(seed)
    means = np.stack([c.x_train.mean(axis=0) for c in dataset.clients])
    proj = rng.normal(size=(means.shape[1], d))
    G = 1e-2 * (means @ proj) + 1e-3 * rng.normal(size=(means.shape[0], d))
    G[list(zero_rows)] = 0.0
    return G.astype(np.float32)


FIXTURES = {
    "by_class_shards": (by_class_shards, ref_by_class_shards, SHARDS),
    "dirichlet_labels": (dirichlet_labels, ref_dirichlet_labels, DIRICHLET),
}


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_datasets_bit_equal(fixture):
    port_fn, ref_fn, kw = FIXTURES[fixture]
    got, want = port_fn(**kw), ref_fn(**kw)
    assert got.n_clients == want.n_clients
    for a, b in zip(got.clients, want.clients):
        for f in ("x_train", "y_train", "x_test", "y_test"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("measure", ["arccos", "l2", "l1"])
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_plan_tokens_equal_reference(fixture, measure):
    port_fn, _, kw = FIXTURES[fixture]
    ds = port_fn(**kw)
    pop = ds.population
    # rows 3, 7, 11: never-sampled clients (the cold-start zero rule)
    G = representative_gradients(ds, zero_rows=(3, 7, 11))
    want = ref_build(pop, M, G, measure=measure, distance_fn=ref_backend("pallas-interpret"))
    got = build_plan_algorithm2(pop, M, torch.from_numpy(G), measure=measure, distance_fn="auto")
    np.testing.assert_array_equal(got.r_tokens, want.r_tokens)
    np.testing.assert_array_equal(got.cluster_of, want.cluster_of)
    if fixture == "dirichlet_labels":
        assert (got.r_tokens[0] == pop.total_samples).sum() == 1  # the dedicated urn
    # the cold-start rows share one cluster
    assert len(set(got.cluster_of[[3, 7, 11]])) == 1


# every distance_fn name the reference takes; "pallas" is the compiled TPU
# kernel there and refuses any other backend, so its port (the same
# similarity op as every device name) is held to the reference's
# interpret-mode build of the same kernel
DISTANCE_NAMES = [None, "numpy", "auto", "streamed", "chunked", "pallas", "pallas-interpret"]
REF_NAME = {"pallas": "pallas-interpret"}


@pytest.mark.parametrize("measure", ["arccos", "l1"])
@pytest.mark.parametrize("name", DISTANCE_NAMES, ids=str)
def test_every_distance_name_builds_the_reference_plan(name, measure):
    from repro.fl.experiment import build_sampler as ref_build_sampler
    from repro_torch.fl.experiment import build_sampler

    ds = dirichlet_labels(**DIRICHLET)
    pop = ds.population
    G = representative_gradients(ds, d=40, zero_rows=(3, 7))
    spec = {"name": "algorithm2", "m": M, "seed": 2,
            "options": {"measure": measure, "distance_fn": name}}
    ref_spec = {**spec, "options": {"measure": measure, "distance_fn": REF_NAME.get(name, name)}}
    got = build_sampler(spec, pop, update_dim=40, device="cpu")
    want = ref_build_sampler(ref_spec, pop, update_dim=40)
    try:
        ids = np.setdiff1d(np.arange(pop.n_clients), [3, 7])
        want.observe_updates(ids, G[ids])
        got.observe_updates(ids, torch.from_numpy(G[ids]))
        np.testing.assert_array_equal(got.plan.r_tokens, want.plan.r_tokens)
        np.testing.assert_array_equal(got.plan.cluster_of, want.plan.cluster_of)
    finally:
        got.close()
        want.close()


def test_unknown_distance_name_raises_like_the_reference():
    from repro.core.samplers.algorithm2 import _resolve_distance_fn as ref_resolve
    from repro_torch.core.samplers.algorithm2 import _resolve_distance_fn

    with pytest.raises(ValueError, match="unknown distance backend 'bogus'"):
        ref_resolve("bogus")
    with pytest.raises(ValueError, match="unknown distance backend 'bogus'"):
        _resolve_distance_fn("bogus")
