"""The port's spec layer against the JAX package's: the same dicts, the same
errors, the same plans, and whole runs of every sampler side by side."""
import json

import numpy as np
import pytest

import repro_torch.models.simple as port_simple
from repro.fl import experiment as ref_exp
from repro.fl.population import build_population as ref_build_population
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.core import SAMPLERS
from repro_torch.fl import experiment as exp
from repro_torch.fl.partition import by_class_shards
from repro_torch.kernels.sketch.ops import SRPSketcher
from repro_torch.models.simple import params_from_numpy, params_to_numpy
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

DATA = {
    "name": "by_class_shards",
    "options": {"n_classes": 10, "clients_per_class": 2, "train_per_client": 40,
                "test_per_client": 10, "dim": 16},
}
TRAIN = {"n_rounds": 3, "n_local_steps": 5, "batch_size": 8, "hidden": [8], "lr": 0.05}
M = 5
GROUPS = [list(range(i * 4, (i + 1) * 4)) for i in range(M)]  # 4 clients of 2 classes each
SAMPLER_SPECS = {
    "md": {"name": "md", "m": M},
    "uniform": {"name": "uniform", "m": M},
    "algorithm1": {"name": "algorithm1", "m": M},
    "algorithm2": {"name": "algorithm2", "m": M},
    "target": {"name": "target", "m": M, "options": {"groups": GROUPS}},
}
# every section away from its default
FULL = {
    "data": {"name": "dirichlet_labels", "options": {"alpha": 0.1, "dim": 8, "seed": 3}},
    "sampler": {"name": "algorithm2", "m": 7, "seed": 4, "options": {"measure": "l1"}},
    "planner": {"mode": "async", "clusterer": "kmeans", "drift_threshold": 0.3,
                "sketch": "srp", "sketch_dim": 16},
    "engine": {"name": "compat", "mesh_spec": [2, 4], "max_staged_bytes": 1 << 20},
    "train": {"n_rounds": 4, "hidden": [16, 8], "momentum": 0.9, "fedprox_mu": 0.01,
              "checkpoint_every": 2, "n_classes": 10, "model_seed": 9},
    "population": {"name": "poisson", "seed": 2, "options": {"leave_rate": 0.2}},
    "scheduler": {"name": "deadline", "options": {"deadline": 1.5}, "track_availability": True,
                  "avail_decay": 0.8},
}


def _spec(sampler: str, **sections) -> dict:
    return {"data": DATA, "sampler": SAMPLER_SPECS[sampler], "train": TRAIN, **sections}


# --------------------------------------------------------------------------
# dicts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [FULL, _spec("target"), _spec("md")], ids=["full", "target", "md"])
def test_spec_round_trip_and_to_dict_equal_reference(d):
    spec = exp.ExperimentSpec.from_dict(d)
    assert exp.ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert exp.ExperimentSpec.from_json(spec.to_json()) == spec
    want = ref_exp.ExperimentSpec.from_dict(d).to_dict()
    got = spec.to_dict()
    assert list(got) == list(want)
    for section in want:
        assert got[section] == want[section], section
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_load_spec_dict_reads_a_file_or_inline_json(tmp_path):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(FULL))
    assert exp.load_spec_dict(str(path)) == exp.load_spec_dict(json.dumps(FULL)) == FULL
    assert exp.ExperimentSpec.from_arg(str(path)) == exp.ExperimentSpec.from_dict(FULL)
    with pytest.raises(ValueError, match="neither an existing file nor valid JSON"):
        exp.load_spec_dict("{nope")


# --------------------------------------------------------------------------
# errors: the same messages as the reference's
# --------------------------------------------------------------------------
POP = by_class_shards(**DATA["options"]).population

ERROR_CASES = {
    "unknown section": lambda m: m.ExperimentSpec.from_dict({**_spec("md"), "bogus": {}}),
    "missing section": lambda m: m.ExperimentSpec.from_dict({"data": DATA}),
    "missing m": lambda m: m.SamplerSpec.from_dict({"name": "md"}),
    "planner mode": lambda m: m.PlannerSpec(mode="fast"),
    "two schedules": lambda m: m.PlannerSpec(drift_threshold=0.3, rebuild_every=2),
    "sketch_dim alone": lambda m: m.PlannerSpec(sketch_dim=8),
    "unknown dataset": lambda m: m.build_dataset({"name": "mnist"}),
    "dataset option": lambda m: m.build_dataset({"name": "by_class_shards", "options": {"bogus": 1}}),
    "sampler option": lambda m: m.build_sampler({"name": "md", "m": M, "options": {"measure": "l1"}}, POP),
    "planless planner": lambda m: m.build_sampler({"name": "md", "m": M}, POP,
                                                  planner=m.PlannerSpec(mode="async")),
    "no update_dim": lambda m: m.build_sampler({"name": "algorithm2", "m": M}, POP),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_match_reference(case):
    with pytest.raises(ValueError) as want:
        ERROR_CASES[case](ref_exp)
    with pytest.raises(ValueError) as got:
        ERROR_CASES[case](exp)
    assert str(got.value).replace("repro_torch.", "repro.") == str(want.value)


def test_unknown_sampler_names_the_ports_samplers():
    with pytest.raises(ValueError) as want:
        ref_exp.build_sampler({"name": "mdd", "m": M}, POP)
    with pytest.raises(ValueError) as got:
        exp.build_sampler({"name": "mdd", "m": M}, POP)
    ref_names = str(sorted(ref_exp.SAMPLERS.names()))
    assert str(got.value) == str(want.value).replace(ref_names, str(SAMPLERS.names()))
    assert "did you mean 'md'?" in str(got.value)


def test_device_is_not_a_spec_option():
    with pytest.raises(ValueError, match=r"does not accept option\(s\) \['device'\]"):
        exp.build_sampler({"name": "algorithm2", "m": M, "options": {"device": "cpu"}}, POP,
                          update_dim=4, device="cpu")


@pytest.mark.parametrize("mesh_spec", ["auto", [1, 1]])
def test_engine_mesh_spec_builds_and_round_trips(mesh_spec):
    """The engine's mesh (once refused, naming ROADMAP A13) builds: the
    server and the scheme's store get it, and the spec round-trips to the
    reference's dict."""
    spec = {**_spec("algorithm2"), "engine": {"mesh_spec": mesh_spec}}
    parsed = exp.ExperimentSpec.from_dict(spec)
    assert exp.ExperimentSpec.from_dict(parsed.to_dict()) == parsed
    assert parsed.to_dict() == ref_exp.ExperimentSpec.from_dict(spec).to_dict()
    with exp.build_experiment(spec, device="cpu") as srv:
        assert srv.mesh is not None and srv.mesh.shape == {"data": 1, "model": 1}
        assert srv._engine.mesh is srv.mesh
        assert srv.sampler.gradient_store.mesh is not None
        assert len(srv.run().records) == TRAIN["n_rounds"]


@pytest.mark.parametrize("section,value,want", [
    ("scheduler", {"name": "deadline"}, "DeadlineScheduler"),
    ("scheduler", {"name": "overselect", "track_availability": True}, "OverselectScheduler"),
    ("scheduler", {"name": "deadline", "options": {"harvest_discount": 0.25}}, "DeadlineScheduler"),
    ("train", {**TRAIN, "checkpoint_every": 2}, None),
])
def test_scheduler_and_checkpoint_sections_build(section, value, want):
    """The sections the port once refused (round schedulers, the checkpoint
    cadence) build as the reference builds them."""
    spec = {**_spec("md"), section: value}
    with exp.build_experiment(spec, device="cpu", checkpoint_path="unused.npz") as srv:
        ref = ref_exp.build_experiment(spec, checkpoint_path="unused.npz")
        assert type(srv.scheduler).__name__ == type(ref.scheduler).__name__
        assert (want is None) == (srv.scheduler is None)
        assert (srv.availability is None) == (ref.availability is None)
        assert srv.cfg.checkpoint_every == ref.cfg.checkpoint_every
        assert srv.cfg.checkpoint_path == "unused.npz"
        if want == "DeadlineScheduler":
            assert srv.scheduler.harvest_discount == ref.scheduler.harvest_discount


def test_sync_scheduler_options_raise_as_the_reference():
    spec = {**_spec("md"), "scheduler": {"name": "sync", "options": {"beta": 0.5}}}
    with pytest.raises(ValueError) as want:
        ref_exp.build_experiment(spec)
    with pytest.raises(ValueError) as got:
        exp.build_experiment(spec, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("section,value", [
    ("population", {"name": "poisson", "options": {"leave_rate": 0.2}}),
    ("population", {"name": "periodic", "seed": 3, "options": {"period": 4}}),
    ("scheduler", {"track_availability": True, "avail_decay": 0.8}),
])
def test_population_and_tracking_sections_build(section, value):
    with exp.build_experiment({**_spec("algorithm2"), section: value}, device="cpu") as srv:
        if section == "population":
            want = ref_build_population(value, srv.dataset.n_clients)
            assert type(srv.population).__name__ == type(want).__name__
            np.testing.assert_array_equal(srv.population.available_mask(3), want.available_mask(3))
            assert srv.availability is None
        else:
            assert srv.population is None
            assert srv.availability.decay == 0.8
            assert srv.sampler._avail_tracker is srv.availability


def test_default_device_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exp.build_experiment(_spec("md"))


# --------------------------------------------------------------------------
# build_sampler: the same plan for each name
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SAMPLER_SPECS))
def test_build_sampler_plans_equal_reference(name):
    ref_pop = ref_exp.build_dataset(DATA).population
    want = ref_exp.build_sampler(SAMPLER_SPECS[name], ref_pop, update_dim=12)
    got = exp.build_sampler(SAMPLER_SPECS[name], POP, update_dim=12, device="cpu")
    try:
        assert type(got).__name__ == type(want).__name__
        if want.plan is None:
            assert got.plan is None
        else:
            np.testing.assert_array_equal(got.plan.r, want.plan.r)
            if want.plan.r_tokens is not None:
                np.testing.assert_array_equal(got.plan.r_tokens, want.plan.r_tokens)
                np.testing.assert_array_equal(got.plan.cluster_of, want.plan.cluster_of)
        for t in range(5):
            np.testing.assert_array_equal(got.sample(t).agg_weights, want.sample(t).agg_weights)
    finally:
        got.close()
        want.close()


# --------------------------------------------------------------------------
# whole runs, side by side
# --------------------------------------------------------------------------
def _carried_init(dims, seed=0, device="cuda"):
    """The reference's initial parameters, carried into the port."""
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


def _run(srv):
    recs, plans = [], []

    def on_round(rec):
        recs.append(rec)
        plan = srv.sampler.plan
        plans.append(None if plan is None or plan.r_tokens is None else np.array(plan.r_tokens))

    with srv:
        srv.run(on_round=on_round)
    return recs, plans


RUNS = {name: _spec(name) for name in SAMPLER_SPECS}
RUNS["algorithm2+srp"] = _spec("algorithm2", planner={"sketch": "srp", "sketch_dim": 8})


@pytest.mark.parametrize("run", sorted(RUNS))
def test_whole_run_matches_reference(run, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    ref_srv = ref_exp.build_experiment(RUNS[run])
    want, want_plans = _run(ref_srv)
    srv = exp.build_experiment(RUNS[run], device="cpu")
    got, got_plans = _run(srv)

    assert len(got) == len(want) == TRAIN["n_rounds"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_distinct_clients, g.n_distinct_classes) == (w.n_distinct_clients, w.n_distinct_classes)
        assert (g.plan_version, g.plan_lag_rounds) == (w.plan_version, w.plan_lag_rounds)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=1e-4)
    for g, w in zip(got_plans, want_plans):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
    final = params_to_numpy(srv.params)
    for k, v in ref_srv.params.items():
        np.testing.assert_allclose(final[k], np.asarray(v), atol=1e-4)


def test_sketch_threads_through_to_the_store():
    spec = _spec("algorithm2", planner={"sketch": "srp", "sketch_dim": 8})
    with exp.build_experiment(spec, device="cpu") as srv:
        store = srv.sampler._store
        assert isinstance(store.sketch, SRPSketcher)
        assert store.dim == 8 and tuple(store.snapshot().shape) == (POP.n_clients, 8)
        assert store.update_dim == sum(v.numel() for v in srv.params.values())
