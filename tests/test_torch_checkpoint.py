"""The port's checkpoint layer and crash-safe server state: the reference's
leaf keys, bit-identical kill/resume for every scheme, the guards, the
service cadence, and bundles that cross between the two packages."""
import json
import os

import numpy as np
import pytest
import torch

import repro_torch.models.simple as port_simple
from repro.checkpoint import io as ref_io
from repro.fl import experiment as ref_exp
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.checkpoint import io
from repro_torch.checkpoint import peek_meta, restore_checkpoint, save_checkpoint
from repro_torch.fl import experiment as exp
from repro_torch.models.simple import params_from_numpy
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

SPEC = {
    "data": {"name": "by_class_shards",
             "options": {"clients_per_class": 2, "train_per_client": 40, "dim": 8,
                         "n_classes": 4, "seed": 0}},
    "sampler": {"name": "algorithm2", "m": 4, "seed": 3},
    "train": {"n_rounds": 6, "n_local_steps": 3, "batch_size": 10, "seed": 1},
    "population": {"name": "poisson",
                   "options": {"join_rate": 0.4, "leave_rate": 0.4, "drop_rate": 0.15}},
}
KILL = 3
DEADLINE = {"name": "deadline", "options": {"straggle_frac": 0.5, "harvest_discount": 0.5},
            "track_availability": True, "avail_threshold": 0.95}


def _spec(**over) -> dict:
    return {**SPEC, **over}


def _carried_init(dims, seed=0, device="cuda"):
    """The reference's initial parameters, carried into the port."""
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


@pytest.fixture(autouse=True)
def _reference_init(monkeypatch):
    """Every run here starts from the reference's parameters, so each run
    draws what the reference's own run of the spec draws."""
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)


def _canon(history) -> list:
    """History records with wall-clock telemetry (plan_build_ms) normalized."""
    recs = json.loads(history.to_json())
    for r in recs:
        r["plan_build_ms"] = -1.0
    return recs


def _run_full(spec):
    with exp.build_experiment(spec, device="cpu") as srv:
        return srv.run(), {k: v.clone() for k, v in srv.params.items()}


def _run_interrupted(spec, path, kill_at=KILL, check=None):
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        for t in range(kill_at):
            srv.run_round(t)
        if check is not None:
            check(srv)
        srv.checkpoint()
    # the process "dies" here; a fresh build restores from the bundle
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        assert srv.resume() == kill_at
        return srv.run(), srv.params


def _assert_resume_bit_identical(spec, tmp_path, check=None):
    full, params = _run_full(spec)
    resumed, got = _run_interrupted(spec, str(tmp_path / "ck.npz"), check=check)
    assert _canon(full) == _canon(resumed)
    for k, v in params.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the bundle format
# --------------------------------------------------------------------------
def _tree(rng):
    return {
        "zeta": {"b": rng.normal(size=(3,)), "a": [rng.normal(size=(2, 2)), None,
                                                   (np.int64(4), rng.integers(0, 5, size=4))]},
        "alpha": rng.normal(size=()).astype(np.float32),
        "m": {"10": np.ones(1), "9": np.zeros(2), "x_y": np.arange(3, dtype=np.int32)},
    }


def test_leaf_keys_and_values_equal_reference_flatten():
    tree = _tree(np.random.default_rng(0))
    want = ref_io._flatten(tree)
    got = io._flatten(tree)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # tensors flatten to the same keys as the numpy arrays they hold
    as_tensors = {"p": {"w1": torch.ones(2, 3), "b0": torch.zeros(3, dtype=torch.float64)},
                  "h": torch.ones(2, dtype=torch.bfloat16)}
    flat = io._flatten(as_tensors)
    assert list(flat) == list(ref_io._flatten({"p": {"w1": 0, "b0": 0}, "h": 0}))
    assert flat["p/b0"].dtype == np.float64 and flat["h"].dtype == np.float32


def test_restore_keeps_the_references_residence_and_dtype(tmp_path):
    path = str(tmp_path / "b.npz")
    tree = {"host": np.arange(6, dtype=np.float64).reshape(2, 3), "dev": torch.ones(4),
            "ids": np.array([3, 1], np.int64), "var": {"rows": np.ones((2, 5), np.float32)}}
    save_checkpoint(path, tree, step=7, extra={"k": [1, 2]})
    assert peek_meta(path) == (7, {"k": [1, 2]})
    ref = {"host": np.zeros((2, 3)), "dev": torch.zeros(4, dtype=torch.float64),
           "ids": np.zeros(2, np.int32), "var": {"rows": np.zeros((0, 0), np.float32)}}
    out, step, extra = restore_checkpoint(path, ref, dynamic_prefixes=("var/",))
    assert step == 7 and extra == {"k": [1, 2]} and list(out) == list(ref)
    assert isinstance(out["host"], np.ndarray) and out["host"].dtype == np.float64
    assert isinstance(out["dev"], torch.Tensor) and out["dev"].dtype == torch.float64
    assert out["ids"].dtype == np.int32 and out["var"]["rows"].shape == (2, 5)
    np.testing.assert_array_equal(out["host"], tree["host"])
    # the reference package reads the same bundle
    got, _, _ = ref_io.restore_checkpoint(path, {**ref, "dev": np.zeros(4)},
                                          dynamic_prefixes=("var/",))
    np.testing.assert_array_equal(got["host"], tree["host"])
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, ref)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(path, {**ref, "extra_leaf": np.zeros(1)}, dynamic_prefixes=("var/",))
    with pytest.raises(KeyError, match="refusing to silently drop"):
        restore_checkpoint(path, {k: v for k, v in ref.items() if k != "ids"},
                           dynamic_prefixes=("var/",))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]  # atomic write


# --------------------------------------------------------------------------
# kill / resume, bit for bit
# --------------------------------------------------------------------------
SAMPLERS = {
    "md": {"name": "md", "m": 4, "seed": 3},
    "algorithm1": {"name": "algorithm1", "m": 4, "seed": 3},
    "uniform": {"name": "uniform", "m": 4, "seed": 3},
    "algorithm2": {"name": "algorithm2", "m": 4, "seed": 3},
    "stratified": {"name": "stratified", "m": 4, "seed": 3},
    "importance": {"name": "importance", "m": 4, "seed": 3, "options": {"mix": 0.3}},
    "dp_stratified": {"name": "dp_stratified", "m": 4, "seed": 3,
                      "options": {"noise_multiplier": 2.0}},
    "hybrid": {"name": "hybrid", "m": 4, "seed": 3},
}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_kill_resume_bit_identical(tmp_path, sampler):
    _assert_resume_bit_identical(_spec(sampler=SAMPLERS[sampler]), tmp_path)


@pytest.mark.parametrize("planner", [
    {"rebuild_every": 2, "sketch": "identity"},
    {"rebuild_every": 2, "sketch": "srp", "sketch_dim": 16, "clusterer": "kmeans"},
    {"sketch": "srp", "sketch_dim": 16},
], ids=["identity", "srp16+kmeans", "srp16"])
def test_kill_resume_bit_identical_sketched(tmp_path, planner):
    _assert_resume_bit_identical(_spec(planner=planner), tmp_path)


@pytest.mark.parametrize("scheduler", [DEADLINE, {"name": "overselect", "options": {"beta": 0.5}}],
                         ids=["deadline+tracker", "overselect"])
def test_kill_resume_bit_identical_scheduled(tmp_path, scheduler):
    def pending(srv):
        # the bundle must carry real pending state, not only the empty case
        if scheduler["name"] == "deadline":
            assert srv.scheduler._harvest_ids.size > 0
            assert srv.availability.min_score() < 1.0
    _assert_resume_bit_identical(_spec(scheduler=scheduler), tmp_path, check=pending)


def test_resume_loads_the_plan_without_a_rebuild(tmp_path):
    """A restored plan is loaded, not rebuilt: no distance is computed at a
    resume, only at the next observation; restored tensors land on the
    server's device."""
    path = str(tmp_path / "ck.npz")
    spec = _spec(scheduler=DEADLINE)
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        for t in range(KILL):
            srv.run_round(t)
        srv.checkpoint()
        want_r = srv.sampler.plan.r.copy()
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        calls = []
        dist = srv.sampler._distance_fn
        srv.sampler._distance_fn = lambda G, measure: (calls.append(1), dist(G, measure))[1]
        srv.resume()
        assert calls == []
        np.testing.assert_array_equal(srv.sampler.plan.r, want_r)
        assert all(isinstance(v, torch.Tensor) and v.device == srv.device
                   for v in srv.params.values())
        assert srv.sampler.gradient_store._G.device == srv.device
        assert isinstance(srv.scheduler._harvest_vals, torch.Tensor)
        srv.run_round(KILL)
        assert calls  # the next observation rebuilds


def test_async_planner_checkpoint_captures_sync_fixed_point(tmp_path):
    spec = _spec(planner={"mode": "async", "rebuild_every": 1},
                 population={"name": "poisson", "options": {"leave_rate": 0.2, "drop_rate": 0.05}})
    path = str(tmp_path / "ck.npz")
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        for t in range(KILL):
            srv.run_round(t)
        srv.checkpoint()
        plan_r = srv.sampler.plan.r.copy()
        meta = srv.sampler.state_meta()
        g = srv.sampler.gradient_store.asnumpy()
    # the sync planner's plan from the same store is the fixed point
    with exp.build_experiment({**spec, "planner": {"rebuild_every": 1}}, device="cpu") as sync:
        sync.sampler.gradient_store.load(g)
        np.testing.assert_array_equal(sync.sampler._build_plan(sync.sampler.gradient_store.snapshot()).r,
                                      plan_r)
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        assert srv.resume() == KILL
        np.testing.assert_array_equal(srv.sampler.plan.r, plan_r)
        restored = srv.sampler.state_meta()
        assert (restored["obs_seen"], restored["plan_version"], restored["rng"]) == (
            meta["obs_seen"], meta["plan_version"], meta["rng"])
        np.testing.assert_array_equal(srv.sampler.gradient_store.asnumpy(), g)
        hist = srv.run()
    assert [r.round for r in hist.records] == list(range(SPEC["train"]["n_rounds"]))


def test_dp_ledger_survives_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    spec = _spec(sampler=SAMPLERS["dp_stratified"])
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        for t in range(KILL):
            srv.run_round(t)
        srv.checkpoint()
        ledger = srv.sampler.privacy_ledger
        dp_rng = srv.sampler._dp_rng.bit_generator.state
    assert ledger["observations"] == KILL and ledger["epsilon"] > 0
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        srv.resume()
        assert srv.sampler.privacy_ledger == ledger
        assert srv.sampler._dp_rng.bit_generator.state == dp_rng
        srv.run()
        assert srv.sampler.privacy_ledger["observations"] == SPEC["train"]["n_rounds"]


# --------------------------------------------------------------------------
# guards
# --------------------------------------------------------------------------
def _bundle(spec, path):
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        srv.run_round(0)
        srv.checkpoint()


REJECTS = {
    "cross-scheme": (_spec(sampler=SAMPLERS["stratified"]),
                     _spec(sampler={"name": "dp_stratified", "m": 4, "seed": 3}),
                     ValueError, "scheme"),
    "scheduler-free": (_spec(), _spec(scheduler=DEADLINE), ValueError, "scheduler-free"),
    "tracker-free": (_spec(scheduler={"name": "deadline"}), _spec(scheduler=DEADLINE),
                     ValueError, "tracker-free"),
    "other scheduler": (_spec(scheduler={"name": "overselect"}), _spec(scheduler={"name": "deadline"}),
                        KeyError, "missing leaf"),
    "sketch width": (_spec(planner={"sketch": "srp", "sketch_dim": 16}), _spec(),
                     ValueError, "shape"),
    "sketch kind": (_spec(planner={"sketch": "srp", "sketch_dim": 16}),
                    _spec(planner={"sketch": "countsketch", "sketch_dim": 16}), ValueError, "sketch"),
    "sampler structure": (_spec(), _spec(sampler=SAMPLERS["md"]), KeyError, "leaf"),
    "tracker knobs": (_spec(scheduler=DEADLINE),
                      _spec(scheduler={**DEADLINE, "avail_decay": 0.5}), ValueError, "knobs"),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_mismatched_bundles_are_rejected(tmp_path, case):
    written, other, err, match = REJECTS[case]
    path = str(tmp_path / "ck.npz")
    _bundle(written, path)
    with exp.build_experiment(other, device="cpu") as srv:
        with pytest.raises(err, match=match):
            srv.resume(path)


def test_checkpoint_without_path_is_an_error():
    with exp.build_experiment(_spec(), device="cpu") as srv:
        with pytest.raises(ValueError, match="checkpoint path"):
            srv.checkpoint()
        with pytest.raises(ValueError, match="checkpoint path"):
            srv.resume()


# --------------------------------------------------------------------------
# the service loop: cadence, cursor, stop flag
# --------------------------------------------------------------------------
def test_run_checkpoint_cadence_and_cursor(tmp_path):
    path = str(tmp_path / "svc.npz")
    spec = _spec(train={**SPEC["train"], "n_rounds": 5, "checkpoint_every": 2})
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        writes = []
        save = srv.checkpoint
        srv.checkpoint = lambda *a: writes.append(srv._round_cursor) or save(*a)
        srv.run()
    assert writes == [2, 4]  # round 5 is off-cadence
    with exp.build_experiment(spec, device="cpu", checkpoint_path=path) as srv:
        assert srv.resume() == 4
        hist = srv.run()
    assert [r.round for r in hist.records] == [0, 1, 2, 3, 4]


def test_should_stop_checkpoints_and_resume_extends_history(tmp_path):
    path = str(tmp_path / "svc.npz")
    calls = {"n": 0}

    def stop_after_3():
        calls["n"] += 1
        return calls["n"] >= 3

    with exp.build_experiment(_spec(), device="cpu", checkpoint_path=path) as srv:
        srv.run(should_stop=stop_after_3)
        assert len(srv.history.records) == 3
        rng_state = srv._rng.bit_generator.state
        pre = srv.history.to_json()
    with exp.build_experiment(_spec(), device="cpu", checkpoint_path=path) as srv:
        assert srv._rng.bit_generator.state != rng_state  # a fresh build is at the origin
        assert srv.resume() == 3
        assert srv.history.to_json() == pre
        assert srv._rng.bit_generator.state == rng_state
        hist = srv.run()
    assert [r.round for r in hist.records] == list(range(SPEC["train"]["n_rounds"]))


# --------------------------------------------------------------------------
# bundles across the two packages
# --------------------------------------------------------------------------
CROSS = _spec(scheduler=DEADLINE)


def _records(srv, start=0):
    recs, plans = [], []

    def on_round(rec):
        recs.append(rec)
        plans.append((srv.sampler.plan.r_tokens.copy(), srv.sampler.plan.cluster_of.copy()))

    if start:
        assert srv.resume() == start
    srv.run(on_round=on_round)
    return recs, plans


def _assert_continuation_equal(got, want):
    (g_recs, g_plans), (w_recs, w_plans) = got, want
    assert [r.round for r in g_recs] == [r.round for r in w_recs]
    for g, w in zip(g_recs, w_recs):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_late, g.n_harvested, g.n_dropped, g.n_available, g.plan_version) == (
            w.n_late, w.n_harvested, w.n_dropped, w.n_available, w.plan_version)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
    for g, w in zip(g_plans, w_plans):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bundle_resumes_in_the_other_package(tmp_path, writer):
    """A bundle written at round 3 by one package resumes in the other, and
    the continuation matches the writer's own uninterrupted run: plans and
    agg_weights equal, losses within 1e-4."""
    path = str(tmp_path / "ck.npz")
    build = {
        "reference": lambda **kw: ref_exp.build_experiment(CROSS, **kw),
        "port": lambda **kw: exp.build_experiment(CROSS, device="cpu", **kw),
    }
    reader = "port" if writer == "reference" else "reference"
    with build[writer]() as srv:
        recs, plans = _records(srv)
        want = (recs[KILL:], plans[KILL:])
    with build[writer](checkpoint_path=path) as srv:
        for t in range(KILL):
            srv.run_round(t)
        assert srv.scheduler._harvest_ids.size > 0
        srv.checkpoint()
    with build[reader](checkpoint_path=path) as srv:
        got = _records(srv, start=KILL)
        assert len(srv.history.records) == SPEC["train"]["n_rounds"]
    _assert_continuation_equal(got, want)
