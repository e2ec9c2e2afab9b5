"""The port's round schedulers against the JAX package's: the latency model,
the option errors, the overselecting draw, and deadline and overselect
runs side by side; plus the contracts of tests/test_scheduler.py held on the
port (sync parity, harvesting, the all-stragglers round)."""
import json

import numpy as np
import pytest
import torch

import repro_torch.models.simple as port_simple
from repro.core import SAMPLERS as REF_SAMPLERS
from repro.core import ClientPopulation as RefPopulation
from repro.fl import experiment as ref_exp
from repro.fl.scheduler import LatencyModel as RefLatencyModel
from repro.fl.scheduler import build_scheduler as ref_build_scheduler
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.core import SAMPLERS, ClientPopulation, MDSampler, UniformSampler
from repro_torch.fl import experiment as exp
from repro_torch.fl.scheduler import (
    SCHEDULERS,
    DeadlineScheduler,
    LatencyModel,
    OverselectScheduler,
    SyncScheduler,
    build_scheduler,
)
from repro_torch.models.simple import params_from_numpy
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

DATA = {"name": "by_class_shards",
        "options": {"clients_per_class": 2, "train_per_client": 40, "dim": 8,
                    "n_classes": 4, "seed": 0}}
SPEC = {
    "data": DATA,
    "sampler": {"name": "algorithm2", "m": 4, "seed": 3},
    "train": {"n_rounds": 6, "n_local_steps": 3, "batch_size": 10, "seed": 1, "hidden": [8]},
    "population": {"name": "poisson", "options": {"join_rate": 0.3, "leave_rate": 0.3}},
}
DEADLINE = {"name": "deadline", "options": {"straggle_frac": 0.5, "harvest_discount": 0.5},
            "track_availability": True}


def _spec(**over) -> dict:
    return {**SPEC, **over}


def _carried_init(dims, seed=0, device="cuda"):
    """The reference's initial parameters, carried into the port."""
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


def _canon(history) -> list:
    """History records with wall-clock telemetry normalized."""
    recs = json.loads(history.to_json())
    for r in recs:
        r["plan_build_ms"] = -1.0
    return recs


def _run(spec):
    with exp.build_experiment(spec, device="cpu") as srv:
        return srv.run()


# --------------------------------------------------------------------------
# latency model and the registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("frac,slow", [(0.3, 2.0), (0.0, 2.0), (1.0, 0.5), (0.7, 0.0)])
def test_latency_model_bit_equal_reference(frac, slow):
    got = LatencyModel(32, seed=7, straggle_frac=frac, slow_factor=slow)
    want = RefLatencyModel(32, seed=7, straggle_frac=frac, slow_factor=slow)
    for t in (0, 1, 5, 1000):
        np.testing.assert_array_equal(got.latencies(t), want.latencies(t))
    np.testing.assert_array_equal(got.latencies(5), got.latencies(5))
    if frac == 0.0:
        assert (got.latencies(0) < 1.0).all()
    if frac == 1.0 and slow >= 1.0:
        assert (got.latencies(0) > 1.0).all()


BAD = {
    "unknown option": {"name": "deadline", "options": {"beta": 0.5}},
    "sync options": {"name": "sync", "options": {"deadline": 2.0}},
    "unknown name": {"name": "deadlin"},
    "deadline <= 0": {"name": "deadline", "options": {"deadline": 0.0}},
    "discount > 1": {"name": "deadline", "options": {"harvest_discount": 1.5}},
    "straggle_frac": {"name": "deadline", "options": {"straggle_frac": -0.1}},
    "slow_factor": {"name": "deadline", "options": {"slow_factor": -1.0}},
    "beta <= 0": {"name": "overselect", "options": {"beta": 0.0}},
    "device option": {"name": "deadline", "options": {"device": "cpu"}},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_build_scheduler_errors_match_reference(case):
    with pytest.raises(ValueError) as want:
        ref_build_scheduler(BAD[case], n_clients=8, m=4)
    with pytest.raises(ValueError) as got:
        build_scheduler(BAD[case], n_clients=8, m=4, device="cpu")
    assert str(got.value) == str(want.value)


def test_build_scheduler_builds_the_references_schedulers():
    assert SCHEDULERS.names() == ["deadline", "overselect", "sync"]
    got = build_scheduler({"name": "deadline", "options": {"straggle_frac": 0.5}, "seed": 9},
                          n_clients=8, m=4, device="cpu")
    want = ref_build_scheduler({"name": "deadline", "options": {"straggle_frac": 0.5}, "seed": 9},
                               n_clients=8, m=4)
    assert isinstance(got, DeadlineScheduler) and got.seed == want.seed == 9
    assert got.model.straggle_frac == want.model.straggle_frac == 0.5
    assert got.device.type == "cpu"
    over = build_scheduler({"name": "overselect", "options": {"beta": 0.3}}, n_clients=8, m=4)
    assert isinstance(over, OverselectScheduler) and over.n_extra == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_scheduler({"name": "deadline"}, n_clients=8, m=4)  # default cuda


# --------------------------------------------------------------------------
# the overselecting draw
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["algorithm1", "algorithm2", "stratified", "hybrid"])
def test_overselect_draws_equal_reference(name):
    """Clients, per-draw weights and realized weights equal the reference's
    over 12 rounds, with and without masks (one masks out every urn of
    some clients), for n_draws from m to 2m + 1."""
    sizes = np.random.default_rng(2).integers(5, 80, size=14)
    kw = {} if name == "algorithm1" else {"update_dim": 6}
    ref = REF_SAMPLERS[name](RefPopulation(sizes), 5, seed=4, **kw)
    port = SAMPLERS[name](ClientPopulation(sizes), 5, seed=4,
                          **({} if name == "algorithm1" else {**kw, "device": "cpu"}))
    rng = np.random.default_rng(1)
    try:
        for t in range(12):
            a = None if t % 3 == 0 else rng.random(14) < 0.5
            n_draws = 5 + t % 7
            want, got = ref.sample_overselect(t, n_draws, a), port.sample_overselect(t, n_draws, a)
            np.testing.assert_array_equal(got.clients, want.clients)
            np.testing.assert_array_equal(got.draw_weights, want.draw_weights)
            np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
            if got.clients.size:
                np.testing.assert_allclose(got.draw_weights.sum(), 1.0, atol=1e-12)
            if name != "algorithm1" and t % 4 == 3:
                ids = np.unique(want.clients)
                G = (1e-2 * rng.normal(size=(ids.size, 6))).astype(np.float32)
                ref.observe_updates(ids, G)
                port.observe_updates(ids, torch.from_numpy(G))
                np.testing.assert_array_equal(port.plan.r, ref.plan.r)
        with pytest.raises(ValueError, match="overselection must cover"):
            port.sample_overselect(0, 4)
    finally:
        ref.close()
        port.close()


def test_overselect_scheduler_thins_as_the_reference():
    sizes = np.random.default_rng(0).integers(5, 60, size=9)
    ref = REF_SAMPLERS["algorithm1"](RefPopulation(sizes), 3, seed=11)
    port = SAMPLERS["algorithm1"](ClientPopulation(sizes), 3, seed=11)
    got_s = OverselectScheduler(9, 3, beta=0.5)
    want_s = ref_build_scheduler({"name": "overselect", "options": {"beta": 0.5}}, n_clients=9, m=3)
    a = np.ones(9, bool)
    a[[2, 5, 7]] = False
    for t in range(10):
        mask = a if t % 2 else None
        got, want = got_s.draw(t, port, mask), want_s.draw(t, ref, mask)
        np.testing.assert_array_equal(got.clients, want.clients)
        np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
        np.testing.assert_array_equal(got.draw_weights, want.draw_weights)
        assert got.stale_weight == want.stale_weight
        assert got.clients.size <= 3
        assert got_s.n_late_extra() == want_s.n_late_extra()
        np.testing.assert_allclose(got.agg_weights.sum() + got.stale_weight, 1.0, atol=1e-12)


def test_overselect_importance_sampler_opts_out():
    pop = ClientPopulation(np.full(6, 10))
    sam = SAMPLERS["importance"](pop, 3, 5, seed=0, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="re-weights its draws"):
            sam.sample_overselect(0, 5)
    finally:
        sam.close()
    with pytest.raises(NotImplementedError, match="holds no sampling plan"):
        UniformSampler(pop, 3).sample_overselect(0, 5)


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------
RUNS = {
    "deadline+algorithm2": _spec(scheduler=DEADLINE),
    "deadline+stratified+srp": _spec(sampler={"name": "stratified", "m": 4, "seed": 3},
                                     planner={"sketch": "srp", "sketch_dim": 8},
                                     scheduler=DEADLINE),
    "deadline+md+drops": _spec(sampler={"name": "md", "m": 4, "seed": 3},
                               population={"name": "static", "options": {"drop_rate": 0.3}},
                               scheduler={"name": "deadline", "options": {"straggle_frac": 0.5}}),
    "overselect+algorithm2": _spec(scheduler={"name": "overselect", "options": {"beta": 0.5}}),
    "overselect+hybrid": _spec(sampler={"name": "hybrid", "m": 4, "seed": 3},
                               scheduler={"name": "overselect", "options": {"beta": 1.0}}),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_whole_scheduled_run_matches_reference(run, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    with ref_exp.build_experiment(RUNS[run]) as ref_srv:
        want = ref_srv.run().records
    with exp.build_experiment(RUNS[run], device="cpu") as srv:
        got = srv.run().records
        store = getattr(srv.sampler, "gradient_store", None)
        if store is not None:
            np.testing.assert_allclose(store.asnumpy(), np.asarray(ref_srv.sampler._store.snapshot()),
                                       atol=1e-5)
    assert len(got) == len(want) == SPEC["train"]["n_rounds"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_late, g.n_harvested, g.n_dropped, g.n_available, g.round_status,
                g.plan_version) == (w.n_late, w.n_harvested, w.n_dropped, w.n_available,
                                    w.round_status, w.plan_version)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=1e-4)
    if run.startswith("deadline"):
        assert sum(r.n_late for r in got) > 0
        if "md" not in run:
            assert sum(r.n_harvested for r in got) > 0
            assert got[0].n_harvested == 0  # harvesting is strictly next-round
    else:
        assert all(r.n_late <= 4 for r in got) and sum(r.n_late for r in got) > 0
        assert any(r.round_status == "ok" for r in got)  # surplus is not degradation


def test_sync_scheduler_hooks_are_free():
    """An explicit SyncScheduler trains bit-identically to none at all."""
    spec = _spec()
    legacy = _run(spec)
    with exp.build_experiment(spec, device="cpu") as srv:
        assert srv.scheduler is None  # the default spec attaches nothing
        srv.scheduler = SyncScheduler(srv.dataset.n_clients, srv.sampler.m)
        explicit = srv.run()
    assert _canon(legacy) == _canon(explicit)


def test_late_updates_skip_observe_and_reach_the_next_rounds_store():
    """No late client's update reaches its round's observe_updates; the next
    round's begin_round scatters exactly those rows, discounted, into the
    store (scatter_scaled's rows equal the engine's rows times 0.5)."""
    spec = _spec(scheduler=DEADLINE)
    with exp.build_experiment(spec, device="cpu") as srv:
        seen, scattered = [], []
        observe, scatter = srv.sampler.observe_updates, srv.sampler.gradient_store.scatter_scaled
        srv.sampler.observe_updates = lambda ids, u: (seen.append(np.array(ids)), observe(ids, u))
        srv.sampler.gradient_store.scatter_scaled = lambda ids, u, scale: (
            scattered.append((np.array(ids), u.clone(), scale)), scatter(ids, u, scale=scale))
        late_by_round = []
        for t in range(6):
            n_seen = len(seen)
            rec = srv.run_round(t)
            late_ids = srv.scheduler._harvest_ids.copy() if rec.n_late else np.empty(0, np.int64)
            late_by_round.append(late_ids)
            observed = seen[-1] if len(seen) > n_seen else []
            assert not set(late_ids) & set(observed)
            assert rec.n_late == late_ids.size
        assert sum(ids.size for ids, _, _ in scattered) == sum(
            r.n_harvested for r in srv.history.records) > 0
        assert all(scale == 0.5 for _, _, scale in scattered)
        assert all(isinstance(u, torch.Tensor) for _, u, _ in scattered)


def test_all_stragglers_is_degraded_not_empty():
    spec = _spec(population={}, scheduler={"name": "deadline", "options": {"straggle_frac": 1.0}})
    with exp.build_experiment(spec, device="cpu") as srv:
        before = {k: v.clone() for k, v in srv.params.items()}
        for t in range(3):
            rec = srv.run_round(t)  # must not raise
            assert rec.round_status == "degraded" and rec.n_late > 0
            assert np.isnan(rec.train_loss)
            assert rec.agg_weights.sum() == 0.0
        assert srv.history.series("n_harvested")[1:].sum() > 0
        for k, v in srv.params.items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)  # stale-only rounds


def test_deadline_with_plan_free_sampler_harvests_nothing():
    md = MDSampler(ClientPopulation(np.full(6, 10)), 3, seed=0)
    sched = DeadlineScheduler(6, 3, straggle_frac=1.0, device="cpu")
    sched.collect(0, np.array([1, 4]), torch.ones((2, 5)))
    assert sched.begin_round(1, md) == 0
    assert sched._harvest_ids.size == 0  # buffer still consumed


def test_harvest_buffer_is_a_device_clone():
    sched = DeadlineScheduler(6, 3, device="cpu")
    rows = torch.arange(10, dtype=torch.float32).reshape(2, 5)
    sched.collect(0, np.array([1, 4]), rows)
    rows.zero_()  # the engine reuses its buffers; the harvest must not move
    assert sched._harvest_vals.sum() == 45
    arrays = sched.state_arrays()
    assert isinstance(arrays["harvest_vals"], np.ndarray)
    fresh = DeadlineScheduler(6, 3, device="cpu")
    fresh.load_state(sched.state_meta(), arrays)
    assert isinstance(fresh._harvest_vals, torch.Tensor)
    torch.testing.assert_close(fresh._harvest_vals, sched._harvest_vals, rtol=0, atol=0)
    with pytest.raises(ValueError, match="inconsistent"):
        fresh.load_state(sched.state_meta(), {"harvest_ids": np.array([1]),
                                              "harvest_vals": arrays["harvest_vals"]})
    with pytest.raises(ValueError, match="cross-scheduler"):
        fresh.load_state({"scheduler": "sync"}, {})
