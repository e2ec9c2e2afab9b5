"""The port's availability tracker, availability-restricted rebuilds, the
drift monitor's churn term and whole churned runs against the JAX package's."""
import numpy as np
import pytest
import torch

import repro_torch.models.simple as port_simple
from repro.core import ClientPopulation as RefPopulation
from repro.core.samplers.algorithm2 import build_plan_algorithm2 as ref_build_algorithm2
from repro.fl import experiment as ref_exp
from repro.fl.availability import AvailabilityTracker as RefTracker
from repro.fl.planner import AssignmentDriftMonitor as RefMonitor
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.benchmarks.table_variance import PROFILE
from repro_torch.core import ClientPopulation, build_plan_algorithm2, validate_plan
from repro_torch.fl import experiment as exp
from repro_torch.fl.availability import AvailabilityTracker
from repro_torch.fl.planner import AssignmentDriftMonitor
from repro_torch.models.simple import params_from_numpy
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

N = 60


def jax_backend_atol(decay: float) -> float:
    """How far the reference's jax backend may sit from its numpy backend
    (and so from the port): the jax fold is one fused multiply-add with
    ``1 − decay`` taken in f32, the numpy fold two rounded products and a
    rounded add. On scores in [0, 1] the two folds of one round differ by
    at most 2 ulp of 1.0 (2·2⁻²⁴), and the difference carried in decays by
    ``decay`` each round, so it stays under 2·2⁻²⁴ / (1 − decay)."""
    return 2 * 2.0**-24 / (1.0 - decay)


def _fold_all(trackers, rounds: int = 20, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = trackers[0].n_clients
    for t in range(rounds):
        mask = None if t % 7 == 6 else rng.random(n) < 0.6
        drawn = rng.choice(n, size=9, replace=False)
        out = dict(on_time=drawn[:4], late=drawn[4:6], crashed=drawn[6:])
        for tr in trackers:
            tr.update(mask, **out)


@pytest.mark.parametrize("decay,late_credit", [(0.9, 0.5), (0.7, 0.3), (0.95, 0.8), (0.5, 0.5)])
def test_tracker_scores_bit_equal_numpy_backend(decay, late_credit):
    kw = dict(decay=decay, threshold=0.4, late_credit=late_credit)
    ref = RefTracker(N, backend="numpy", **kw)
    port = AvailabilityTracker(N, device="cpu", **kw)
    _fold_all([ref, port])
    got, want = port.scores(), ref.scores()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.active_mask(), ref.active_mask())
    np.testing.assert_array_equal(port.active_mask(0.6), ref.active_mask(0.6))
    assert port.min_score() == ref.min_score()
    assert port.rounds_seen == ref.rounds_seen == 20


@pytest.mark.parametrize("decay", [0.9, 0.7, 0.5])
def test_tracker_scores_against_jax_backend(decay):
    """Within the bound on the reference's own jax-vs-numpy difference,
    and bit-equal where every product is exact."""
    kw = dict(decay=decay, threshold=0.25, late_credit=0.5)
    ref = RefTracker(N, backend="jax", **kw)
    port = AvailabilityTracker(N, device="cpu", **kw)
    _fold_all([ref, port])
    np.testing.assert_allclose(port.scores(), ref.scores(), rtol=0, atol=jax_backend_atol(decay))
    if decay == 0.5:  # every product exact: no rounding for the fusion to skip
        np.testing.assert_array_equal(port.scores(), ref.scores())


def test_tracker_holds_an_f32_tensor_on_its_device_replaced_each_fold():
    tr = AvailabilityTracker(8, device="cpu")
    before = tr._scores
    assert before.dtype == torch.float32 and before.device.type == "cpu"
    tr.update(np.ones(8, bool))
    assert tr._scores is not before and (before == 1).all()  # never mutated


@pytest.mark.parametrize("kw", [dict(decay=1.0), dict(threshold=1.5), dict(late_credit=-0.1)])
def test_tracker_errors_equal_reference(kw):
    with pytest.raises(ValueError) as want:
        RefTracker(4, backend="numpy", **kw)
    with pytest.raises(ValueError) as got:
        AvailabilityTracker(4, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="shape"):
        AvailabilityTracker(4, device="cpu").update(np.ones(5, bool))


def test_tracker_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AvailabilityTracker(4)


# --------------------------------------------------------------------------
# availability-restricted rebuilds
# --------------------------------------------------------------------------
SIZES = {"balanced": np.full(100, 500), "unbalanced": PROFILE,
         "random": np.random.default_rng(3).integers(1, 2000, size=37)}


@pytest.mark.parametrize("p_in", [0.0, 0.3, 0.7, 1.0])
@pytest.mark.parametrize("kind", sorted(SIZES))
def test_cluster_mask_plans_equal_reference(kind, p_in):
    sizes = SIZES[kind]
    n = len(sizes)
    G = (1e-2 * np.random.default_rng(5).normal(size=(n, 12))).astype(np.float32)
    mask = np.random.default_rng(6).random(n) < p_in
    want = ref_build_algorithm2(RefPopulation(sizes), 10, G, cluster_mask=mask)
    got = build_plan_algorithm2(ClientPopulation(sizes), 10, torch.from_numpy(G), cluster_mask=mask)
    np.testing.assert_array_equal(got.r_tokens, want.r_tokens)
    np.testing.assert_array_equal(got.cluster_of, want.cluster_of)
    validate_plan(got, ClientPopulation(sizes))
    with pytest.raises(ValueError, match="cluster_mask shape"):
        build_plan_algorithm2(ClientPopulation(sizes), 10, torch.from_numpy(G),
                              cluster_mask=np.ones(n + 1, bool))


def test_drift_churn_term_equals_reference():
    """Assignment churn plus the fraction of clients whose active bit
    flipped, for each pairing of baseline and fresh masks."""
    pop = ClientPopulation(np.full(30, 100))
    G = (1e-2 * np.random.default_rng(0).normal(size=(30, 8))).astype(np.float32)
    plan = build_plan_algorithm2(pop, 6, torch.from_numpy(G))
    rng = np.random.default_rng(1)
    masks = [None, rng.random(30) < 0.5, rng.random(30) < 0.8]
    G2 = G + (1e-2 * rng.normal(size=G.shape)).astype(np.float32)
    for base in masks:
        ref, port = RefMonitor(), AssignmentDriftMonitor()
        ref.rebaseline(G, plan, base)
        port.rebaseline(torch.from_numpy(G), plan, base)
        for fresh in masks:
            assert port.drift(torch.from_numpy(G2), fresh) == ref.drift(G2, fresh)
            assert port._churn(fresh) == ref._churn(fresh)


# --------------------------------------------------------------------------
# build_experiment with churn and tracking, side by side
# --------------------------------------------------------------------------
DATA = {
    "name": "by_class_shards",
    "options": {"n_classes": 10, "clients_per_class": 2, "train_per_client": 40,
                "test_per_client": 10, "dim": 16},
}
TRAIN = {"n_rounds": 6, "n_local_steps": 5, "batch_size": 8, "hidden": [8], "lr": 0.05}
POISSON = {"name": "poisson", "seed": 1, "options": {"join_rate": 0.3, "leave_rate": 0.3}}
TRACK = {"track_availability": True, "avail_threshold": 0.75}
RUNS = {
    "algorithm2+poisson+tracked": ("algorithm2", POISSON, TRACK),
    "algorithm2+poisson+tracked+drift": ("algorithm2", POISSON, TRACK),
    "stratified+poisson+tracked": ("stratified", POISSON, TRACK),
    "hybrid+periodic+tracked": ("hybrid", {"name": "periodic", "options": {"period": 4}}, TRACK),
    "dp_stratified+poisson": ("dp_stratified", POISSON, None),
    "importance+drops+tracked": ("importance", {"name": "static", "options": {"drop_rate": 0.3}}, TRACK),
    "md+dropout": ("md", {"name": "dropout", "options": {"rate": 0.2}}, None),
    "uniform+periodic": ("uniform", {"name": "periodic", "options": {"period": 4}}, None),
}


def _run_spec(run: str) -> dict:
    sampler, population, scheduler = RUNS[run]
    spec = {"data": DATA, "sampler": {"name": sampler, "m": 5}, "train": TRAIN,
            "population": population}
    if scheduler is not None:
        spec["scheduler"] = scheduler
    if run.endswith("+drift"):
        spec["planner"] = {"drift_threshold": 0.2}
    return spec


def _history(srv):
    recs, plans = [], []
    with srv:
        def on_round(rec):
            recs.append(rec)
            plan = srv.sampler.plan
            plans.append(None if plan is None or plan.r_tokens is None
                         else (plan.r_tokens.copy(), plan.cluster_of.copy()))
        srv.run(on_round=on_round)
    return recs, plans


@pytest.mark.parametrize("run", sorted(RUNS))
def test_whole_churned_run_matches_reference(run, monkeypatch):
    """Equal draws (weights bit-equal; importance's within 1e-6), equal
    plans, n_available / n_dropped / round_status equal, losses and
    accuracies within 1e-4, and presence scores within the bound on the
    reference's jax-vs-numpy difference (its server folds with jax)."""
    monkeypatch.setattr(port_simple, "init_mlp", lambda dims, seed=0, device="cuda": params_from_numpy(
        ref_init_mlp(tuple(dims), seed=seed), device=device))
    want, want_plans = _history(ref_exp.build_experiment(_run_spec(run)))
    srv = exp.build_experiment(_run_spec(run), device="cpu")
    if RUNS[run][2] is not None:
        assert srv.availability is not None
        if hasattr(srv.sampler, "attach_availability"):
            assert srv.sampler._avail_tracker is srv.availability
    got, got_plans = _history(srv)
    assert len(got) == len(want) == TRAIN["n_rounds"]
    for g, w in zip(got, want):
        if RUNS[run][0] == "importance":
            np.testing.assert_array_equal(g.agg_weights > 0, w.agg_weights > 0)
            np.testing.assert_allclose(g.agg_weights, w.agg_weights, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_available, g.n_dropped, g.round_status, g.plan_version) == (
            w.n_available, w.n_dropped, w.round_status, w.plan_version)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=1e-4)
        np.testing.assert_allclose(g.avail_score_min, w.avail_score_min, rtol=0,
                                   atol=jax_backend_atol(0.9))
        if RUNS[run][0] != "importance":
            np.testing.assert_allclose(g.plan_drift, w.plan_drift, rtol=0, atol=0)
    for g, w in zip(got_plans, want_plans):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    assert sum(r.n_available < 20 for r in got) > 0 or RUNS[run][1]["name"] != "poisson"


def test_tracked_availability_restricts_the_rebuild_mask():
    spec = _run_spec("algorithm2+poisson+tracked")
    with exp.build_experiment({**spec, "scheduler": {"track_availability": True}},
                              device="cpu") as srv:
        sam = srv.sampler
        assert sam._avail_tracker is srv.availability
        assert sam._cluster_mask() is None  # cold start: everyone at 1.0
        n = srv.dataset.population.n_clients
        only_first = np.zeros(n, bool)
        only_first[0] = True
        for _ in range(16):
            srv.availability.update(only_first)
        mask = sam._cluster_mask()
        assert mask is not None and mask[0] and not mask[1:].any()
