"""The slice as a whole: 3 Algorithm 2 rounds in both packages, side by side."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.samplers.algorithm2 import Algorithm2Sampler as RefSampler
from repro.fl.aggregation import flatten_params as ref_flatten
from repro.fl.partition import by_class_shards as ref_by_class_shards
from repro.fl.server import FederatedServer as RefServer
from repro.fl.server import FLConfig as RefConfig
from repro.models.simple import init_mlp as ref_init_mlp
from repro.optim import sgd as ref_sgd
from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
from repro_torch.fl.partition import by_class_shards
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.models.simple import params_from_numpy, params_to_numpy
from repro_torch.optim.sgd import sgd
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

DATA = dict(n_classes=10, clients_per_class=2, train_per_client=40, test_per_client=10, dim=16, seed=0)
M, ROUNDS, LR = 5, 3, 0.05


def _run(server, sampler):
    plans, recs = [], []

    def on_round(rec):
        recs.append(rec)
        plans.append(np.array(sampler.plan.r_tokens))

    with server:
        server.run(on_round=on_round)
    return recs, plans


@pytest.mark.parametrize(
    "engine,planner",
    [
        ("batched", {}),
        ("compat", {}),
        ("batched", {"rebuild_every": 2}),
        ("batched", {"drift_threshold": 0.3}),
        ("batched", {"sketch": "srp", "sketch_dim": 8}),
        ("batched", {"sketch": "countsketch", "sketch_dim": 8}),
        ("batched", {"sketch": "srp", "sketch_dim": 8, "clusterer": "kmeans"}),
        ("batched", {"clusterer": "ward_jit"}),
    ],
)
def test_slice_matches_reference(engine, planner):
    init = {k: np.asarray(v) for k, v in ref_init_mlp((16, 8, 10), seed=1).items()}
    d = int(ref_flatten(init).shape[0])
    cfg = dict(n_rounds=ROUNDS, n_local_steps=5, batch_size=8, seed=0, engine=engine)

    ref_ds = ref_by_class_shards(**DATA)
    ref_sampler = RefSampler(
        ref_ds.population, M, update_dim=d, seed=0, distance_fn="pallas-interpret", **planner
    )
    ref_srv = RefServer(ref_ds, ref_sampler, {k: jnp.asarray(v) for k, v in init.items()},
                        ref_sgd(LR), RefConfig(**cfg))
    want_recs, want_plans = _run(ref_srv, ref_sampler)

    ds = by_class_shards(**DATA)
    sampler = Algorithm2Sampler(ds.population, M, update_dim=d, seed=0, device="cpu", **planner)
    srv = FederatedServer(ds, sampler, params_from_numpy(init, device="cpu"), sgd(LR),
                          FLConfig(**cfg), device="cpu")
    got_recs, got_plans = _run(srv, sampler)

    assert len(got_recs) == len(want_recs) == ROUNDS
    for g, w in zip(got_recs, want_recs):
        np.testing.assert_array_equal(np.flatnonzero(g.agg_weights), np.flatnonzero(w.agg_weights))
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert g.n_distinct_clients == w.n_distinct_clients
        assert (g.plan_version, g.plan_lag_rounds) == (w.plan_version, w.plan_lag_rounds)
        np.testing.assert_allclose(g.plan_drift, w.plan_drift)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=1e-4)
    for g, w in zip(got_plans, want_plans):
        np.testing.assert_array_equal(g, w)
    # the plan was rebuilt from real updates, not left at the cold start
    assert len(np.unique(sampler.plan.cluster_of[sampler.plan.cluster_of >= 0])) > 1
    final = params_to_numpy(srv.params)
    for k in init:
        np.testing.assert_allclose(final[k], np.asarray(ref_srv.params[k]), atol=1e-4)


def test_async_planner_flushes_to_sync():
    """planner="async" forced to completion each round equals planner="sync"."""
    ds = by_class_shards(**DATA)
    init = {k: np.asarray(v) for k, v in ref_init_mlp((16, 8, 10), seed=1).items()}
    d = sum(v.size for v in init.values())
    plans = {}
    for mode in ("sync", "async"):
        sampler = Algorithm2Sampler(ds.population, M, update_dim=d, seed=0, planner=mode, device="cpu")
        srv = FederatedServer(ds, sampler, params_from_numpy(init, device="cpu"), sgd(LR),
                              FLConfig(n_rounds=ROUNDS, n_local_steps=5, batch_size=8), device="cpu")
        plans[mode] = []

        def on_round(rec, sampler=sampler, mode=mode):
            sampler.flush_plan()
            plans[mode].append(np.array(sampler.plan.r_tokens))

        with srv:
            srv.run(on_round=on_round)
    for a, b in zip(plans["sync"], plans["async"]):
        np.testing.assert_array_equal(a, b)


def test_identity_sketch_history_is_bitwise_unsketched():
    """sketch="identity" runs the unsketched path: the same history, bit for bit."""
    ds = by_class_shards(**DATA)
    init = {k: np.asarray(v) for k, v in ref_init_mlp((16, 8, 10), seed=1).items()}
    d = sum(v.size for v in init.values())
    runs = {}
    for sketch in (None, "identity"):
        sampler = Algorithm2Sampler(ds.population, M, update_dim=d, seed=0, sketch=sketch, device="cpu")
        srv = FederatedServer(ds, sampler, params_from_numpy(init, device="cpu"), sgd(LR),
                              FLConfig(n_rounds=ROUNDS, n_local_steps=5, batch_size=8), device="cpu")
        recs, plans = _run(srv, sampler)
        runs[sketch] = (recs, plans, params_to_numpy(srv.params), sampler._store.asnumpy())
    (r0, p0, w0, g0), (r1, p1, w1, g1) = runs[None], runs["identity"]
    for a, b in zip(r0, r1):
        assert (a.train_loss, a.test_acc) == (b.train_loss, b.test_acc)
        np.testing.assert_array_equal(a.agg_weights, b.agg_weights)
    for a, b in zip(p0, p1):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g0, g1)
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])
