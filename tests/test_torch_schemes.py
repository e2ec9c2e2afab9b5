"""The port's scheme zoo (stratified, hybrid, importance, dp_stratified) and
its scheme race against the JAX package's: plans, draws, the DP release and
whole runs."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.models.simple as port_simple
from repro.core import SAMPLERS as REF_SAMPLERS
from repro.core import ClientPopulation as RefPopulation
from repro.core import build_plan_hybrid as ref_build_hybrid
from repro.core import build_plan_stratified as ref_build_stratified
from repro.core.samplers.schemes import default_n_strata as ref_default_n_strata
from repro.core.samplers.schemes import gaussian_epsilon as ref_gaussian_epsilon
from repro.core.samplers.schemes import importance_probabilities as ref_importance_probabilities
from repro.fl import experiment as ref_exp
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.benchmarks import scheme_race
from repro_torch.benchmarks.table_variance import PROFILE
from repro_torch.core import (
    SAMPLERS,
    ClientPopulation,
    build_plan_hybrid,
    build_plan_stratified,
    validate_plan,
)
from repro_torch.core.samplers.schemes import (
    default_n_strata,
    gaussian_epsilon,
    importance_probabilities,
)
from repro_torch.fl import experiment as exp
from repro_torch.kernels.similarity.ops import make_distance_fn
from repro_torch.models.simple import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference runner lives in the repo's benchmarks/
    sys.path.insert(0, str(ROOT))
from benchmarks import scheme_race as ref_race  # noqa: E402
from repro_torch.testing import pin_cpu_threads  # noqa: E402

pin_cpu_threads()

M, D = 10, 16
ZOO = ("stratified", "hybrid", "dp_stratified", "importance")
SIZES = {
    "balanced": np.full(100, 500),
    "unbalanced": PROFILE,
    "random": np.random.default_rng(3).integers(1, 2000, size=37),
    # m·p_i >= 1 for the first two clients: hybrid's deterministic head
    # holds 4 + 2 dedicated urns, the stratified tail the other 4
    "headed": np.array([5000, 3000] + [100] * 40),
}
Q_RTOL = 1e-6  # importance's q: f32 norms whose reduction order differs (about 1 ulp)


def _G(n: int, seed: int, d: int = D) -> np.ndarray:
    """Representative gradients at update scale (1e-2)."""
    return (1e-2 * np.random.default_rng(seed).normal(size=(n, d))).astype(np.float32)


def _pair(name: str, sizes: np.ndarray, seed: int = 5, **kw):
    ref = REF_SAMPLERS[name](RefPopulation(sizes), M, D, seed=seed, **kw)
    port = SAMPLERS[name](ClientPopulation(sizes), M, D, seed=seed, device="cpu", **kw)
    return ref, port


def _assert_plans_equal(got, want, name: str):
    if name == "importance":
        np.testing.assert_allclose(got.r, want.r, rtol=Q_RTOL, atol=0)
        assert got.r_tokens is None and want.r_tokens is None
        return
    np.testing.assert_array_equal(got.r_tokens, want.r_tokens)
    np.testing.assert_array_equal(got.cluster_of, want.cluster_of)
    np.testing.assert_array_equal(got.r, want.r)


def _carried_init(dims, seed=0, device="cuda"):
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


# --------------------------------------------------------------------------
# plan construction
# --------------------------------------------------------------------------
@pytest.mark.parametrize("measure", ["arccos", "l1"])
@pytest.mark.parametrize("kind", sorted(SIZES))
@pytest.mark.parametrize("which", ["stratified", "hybrid"])
def test_plan_functions_equal_reference(which, kind, measure):
    sizes = SIZES[kind]
    G = _G(len(sizes), 1)
    ref_build, build = {
        "stratified": (ref_build_stratified, build_plan_stratified),
        "hybrid": (ref_build_hybrid, build_plan_hybrid),
    }[which]
    want = ref_build(RefPopulation(sizes), M, G, measure=measure)
    got = build(ClientPopulation(sizes), M, torch.from_numpy(G), measure=measure)
    _assert_plans_equal(got, want, which)
    validate_plan(got, ClientPopulation(sizes))


@pytest.mark.parametrize("clusterer", ["ward_jit", "kmeans"])
@pytest.mark.parametrize("n_strata", [None, 3, 12])
def test_stratified_options_equal_reference(n_strata, clusterer):
    sizes = SIZES["unbalanced"]
    G = _G(len(sizes), 2)
    want = ref_build_stratified(RefPopulation(sizes), M, G, n_strata=n_strata,
                                clusterer=clusterer, seed=4)
    got = build_plan_stratified(ClientPopulation(sizes), M, torch.from_numpy(G),
                                n_strata=n_strata, clusterer=clusterer, seed=4)
    _assert_plans_equal(got, want, "stratified")


@pytest.mark.parametrize("measure", ["arccos", "l1"])
def test_headed_hybrid_draws_equal_reference(measure):
    """The deterministic head against the reference's hybrid: its clients
    own whole urns, so every round draws them, masked or not; draws and
    plans stay equal as the tail re-stratifies."""
    sizes = SIZES["headed"]
    ref, port = _pair("hybrid", sizes, measure=measure)
    rng = np.random.default_rng(1)
    try:
        head = np.flatnonzero((port.plan.r_tokens == ClientPopulation(sizes).total_samples).any(axis=0))
        np.testing.assert_array_equal(head, [0, 1])
        for t in range(12):
            a = None if t % 3 == 0 else rng.random(len(sizes)) < 0.6
            if a is not None:
                a[:2] = True
            want, got = ref.sample(t, a), port.sample(t, a)
            np.testing.assert_array_equal(got.clients, want.clients)
            np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
            assert (got.clients == 0).sum() >= 4 and (got.clients == 1).sum() >= 2
            if t % 4 == 3:
                ids = np.unique(want.clients)
                G = _G(ids.size, t)
                ref.observe_updates(ids, G)
                port.observe_updates(ids, torch.from_numpy(G))
                _assert_plans_equal(port.plan, ref.plan, "hybrid")
    finally:
        ref.close()
        port.close()


def test_hybrid_without_a_head_is_stratified():
    pop = ClientPopulation(np.full(40, 100))  # every m·p_i < 1: no dedicated urn
    G = torch.from_numpy(_G(40, 3))
    a, b = build_plan_hybrid(pop, M, G), build_plan_stratified(pop, M, G)
    np.testing.assert_array_equal(a.r_tokens, b.r_tokens)
    np.testing.assert_array_equal(a.cluster_of, b.cluster_of)


def test_default_n_strata_and_epsilon_equal_reference():
    for n in (1, 2, 3, 37, 100, 10_000):
        assert default_n_strata(n) == ref_default_n_strata(n)
    for rho, delta in ((0.0, 1e-5), (0.5, 1e-5), (3.0, 1e-3)):
        assert gaussian_epsilon(rho, delta) == ref_gaussian_epsilon(rho, delta)


def test_importance_probabilities_equal_reference():
    rng = np.random.default_rng(0)
    p = ClientPopulation(PROFILE).importances
    norms = rng.random(p.size)
    for mix in (0.05, 0.1, 0.5, 1.0):
        np.testing.assert_array_equal(importance_probabilities(p, norms, mix),
                                      ref_importance_probabilities(p, norms, mix))
    # degenerate norms return p exactly
    for norms in (np.zeros(p.size), np.full(p.size, np.nan)):
        np.testing.assert_array_equal(importance_probabilities(p, norms, 0.1), p)


# --------------------------------------------------------------------------
# samplers: plans and draws over rounds, with and without a mask
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(SIZES))
@pytest.mark.parametrize("name", ZOO)
def test_zoo_draws_and_plans_equal_reference(name, kind):
    """30 rounds, every third unmasked and the rest under a random mask;
    updates every 5 rounds rebuild both plans. Draws bit-equal; weights
    bit-equal but for importance, whose p/q correction is within Q_RTOL."""
    sizes = SIZES[kind]
    ref, port = _pair(name, sizes)
    rng = np.random.default_rng(0)
    try:
        _assert_plans_equal(port.plan, ref.plan, name)  # cold start
        for t in range(30):
            a = None if t % 3 == 0 else rng.random(len(sizes)) < 0.6
            want, got = ref.sample(t, a), port.sample(t, a)
            np.testing.assert_array_equal(got.clients, want.clients)
            if name == "importance":
                np.testing.assert_allclose(got.agg_weights, want.agg_weights, rtol=Q_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
            if t % 5 == 4:
                ids = np.unique(want.clients)
                G = _G(ids.size, t)
                ref.observe_updates(ids, G)
                port.observe_updates(ids, torch.from_numpy(G))
                _assert_plans_equal(port.plan, ref.plan, name)
        assert port.plan_telemetry() == ref.plan_telemetry()
    finally:
        ref.close()
        port.close()


def test_importance_correction_equals_reference():
    sizes = SIZES["unbalanced"]
    ref, port = _pair("importance", sizes, mix=0.2)
    try:
        ids = np.arange(len(sizes))
        G = _G(len(sizes), 7)
        ref.observe_updates(ids, G)
        port.observe_updates(ids, torch.from_numpy(G))
        np.testing.assert_allclose(port.plan.r[0], ref.plan.r[0], rtol=Q_RTOL, atol=0)
        assert not np.array_equal(port.plan.r[0], port.population.importances)  # tilted
        rng = np.random.default_rng(1)
        masks = [None, np.ones(len(sizes), bool), np.zeros(len(sizes), bool),
                 rng.random(len(sizes)) < 0.5]
        for a in masks:
            np.testing.assert_allclose(port.correction(a), ref.correction(a), rtol=Q_RTOL, atol=0)
        assert port.supports_overselect is ref.supports_overselect is False
        assert port.validate_plans is ref.validate_plans is False
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("masked", [False, True])
def test_importance_at_mix_one_is_md_bit_for_bit(masked):
    """q = p exactly and the correction is 1.0 elementwise: draws and
    weights equal to md's of the same seed, also after updates."""
    sizes = SIZES["unbalanced"]
    pop = ClientPopulation(sizes)
    imp = SAMPLERS["importance"](pop, M, D, mix=1.0, seed=9, device="cpu")
    md = SAMPLERS["md"](pop, M, seed=9)
    rng = np.random.default_rng(2)
    try:
        for t in range(20):
            a = rng.random(len(sizes)) < 0.5 if masked else None
            want, got = md.sample(t, a), imp.sample(t, a)
            np.testing.assert_array_equal(got.clients, want.clients)
            np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
            imp.observe_updates(np.unique(got.clients), torch.from_numpy(_G(len(np.unique(got.clients)), t)))
    finally:
        imp.close()


def test_importance_rejects_cluster_knobs_like_the_reference():
    pop = ClientPopulation(SIZES["balanced"])
    ref_pop = RefPopulation(SIZES["balanced"])
    for planner in ({"drift_threshold": 0.3}, {"clusterer": "kmeans"}):
        with pytest.raises(ValueError) as want:
            ref_exp.build_sampler({"name": "importance", "m": M}, ref_pop,
                                  planner=ref_exp.PlannerSpec(**planner), update_dim=D)
        with pytest.raises(ValueError) as got:
            exp.build_sampler({"name": "importance", "m": M}, pop,
                              planner=exp.PlannerSpec(**planner), update_dim=D, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mix must be in"):
        SAMPLERS["importance"](pop, M, D, mix=0.0, device="cpu")


# --------------------------------------------------------------------------
# dp_stratified: the noised release
# --------------------------------------------------------------------------
def test_dp_release_bit_equal_and_on_the_stores_device():
    sizes = SIZES["unbalanced"]
    kw = dict(noise_multiplier=0.5, clip_norm=0.05)
    ref, port = _pair("dp_stratified", sizes, **kw)
    try:
        ids = np.arange(len(sizes))
        G = _G(len(sizes), 11)
        G[:5] *= 100  # rows over the clip norm
        ref._store.update(ids, G)
        port._store.update(ids, torch.from_numpy(G))
        for _ in range(3):
            want, got = ref._observe_snapshot(), port._observe_snapshot()
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
            assert got.device == port._store.device
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert port.privacy_ledger == ref.privacy_ledger
        assert port.privacy_ledger["observations"] == 3
    finally:
        ref.close()
        port.close()


def test_dp_plans_and_ledger_equal_reference_over_rounds():
    sizes = SIZES["balanced"]
    ref, port = _pair("dp_stratified", sizes, noise_multiplier=2.0, seed=3)
    try:
        for t in range(12):
            want, got = ref.sample(t), port.sample(t)
            np.testing.assert_array_equal(got.clients, want.clients)
            ids = np.unique(want.clients)
            G = _G(ids.size, 100 + t)
            ref.observe_updates(ids, G)
            port.observe_updates(ids, torch.from_numpy(G))
            _assert_plans_equal(port.plan, ref.plan, "dp_stratified")
        assert port.privacy_ledger == ref.privacy_ledger
    finally:
        ref.close()
        port.close()


def test_distance_op_refuses_a_host_array():
    """No hidden CPU fallback: a numpy G raises instead of reaching the
    plain version on the CPU."""
    fn = make_distance_fn()
    G = _G(6, 0)
    with pytest.raises(TypeError, match="torch tensor"):
        fn(G, "arccos")
    with pytest.raises(TypeError, match="torch tensor"):
        build_plan_stratified(ClientPopulation(np.full(6, 10)), 3, G, distance_fn="auto")
    assert fn(torch.from_numpy(G), "arccos").shape == (6, 6)


# --------------------------------------------------------------------------
# whole runs and the race
# --------------------------------------------------------------------------
DATA = {
    "name": "by_class_shards",
    "options": {"n_classes": 10, "clients_per_class": 2, "train_per_client": 40,
                "test_per_client": 10, "dim": 16},
}
TRAIN = {"n_rounds": 4, "n_local_steps": 5, "batch_size": 8, "hidden": [8], "lr": 0.05}


@pytest.mark.parametrize("name", ZOO)
def test_whole_zoo_run_matches_reference(name, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    spec = {"data": DATA, "sampler": {"name": name, "m": 5}, "train": TRAIN}
    with ref_exp.build_experiment(spec) as srv:
        want = srv.run().records
        want_plan = srv.sampler.plan
    with exp.build_experiment(spec, device="cpu") as srv:
        got = srv.run().records
        _assert_plans_equal(srv.sampler.plan, want_plan, name)
    assert len(got) == len(want) == TRAIN["n_rounds"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.agg_weights > 0, w.agg_weights > 0)
        np.testing.assert_allclose(g.agg_weights, w.agg_weights, rtol=Q_RTOL, atol=0)
        assert g.plan_version == w.plan_version
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=1e-4)


def _rows(text: str) -> dict:
    """{row name: derived column} of the runner's ``name,us,derived`` lines."""
    return dict((line.split(",", 2)[0], line.split(",", 2)[2])
                for line in text.splitlines() if not line.startswith("#"))


def test_scheme_race_smoke_rows_equal_reference(capsys, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    ref_race.main(["--smoke"])
    want = _rows(capsys.readouterr().out)
    scheme_race.main(["--smoke", "--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    assert list(got) == list(want)
    for name in want:
        g = dict(kv.split("=") for kv in got[name].split(";"))
        w = dict(kv.split("=") for kv in want[name].split(";"))
        assert list(g) == list(w)
        for key in w:
            if key in ("status", "seeds", "tta", "wvar"):  # decided by the draws
                assert g[key] == w[key], (name, key)
            else:  # printed to 4 decimals from values within 1e-4
                for a, b in zip(g[key].split("±"), w[key].split("±")):
                    assert abs(float(a) - float(b)) <= 2e-4, (name, key)
    assert [n for n in got if n.startswith("scheme_race/scheme=")] == [
        f"scheme_race/scheme={s}" for s in scheme_race.SMOKE_SCHEMES]


def test_scheme_race_grid_equals_reference():
    for smoke in (True, False):
        assert scheme_race.race_sweep(smoke=smoke) == ref_race.race_sweep(smoke=smoke)
    assert scheme_race.SCHEMES == ref_race.SCHEMES
    assert scheme_race.RACE_STATS == ref_race.RACE_STATS


def test_scheme_race_parity_gate_passes_on_the_cpu(capsys):
    scheme_race.main(["--parity", "--device", "cpu"])
    assert "scheme_race/parity/md_vs_importance,0.00,bit_identical=1" in capsys.readouterr().out


def test_scheme_race_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheme_race.main(["--smoke"])
