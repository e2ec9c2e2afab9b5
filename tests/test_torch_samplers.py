"""The port's samplers against the JAX package's: draws and plans bit for bit."""
import numpy as np
import pytest
import torch

from repro.core import SAMPLERS as REF_SAMPLERS
from repro.core import ClientPopulation as RefPopulation
from repro.core import max_draws_bound as ref_max_draws_bound
from repro.core import validate_plan as ref_validate_plan
from repro.core.samplers.base import conditional_plan as ref_conditional_plan
from repro_torch.benchmarks.table_variance import PROFILE
from repro_torch.core import (
    SAMPLERS,
    ClientPopulation,
    build_plan_algorithm1,
    build_plan_target,
    max_draws_bound,
    register_sampler,
    validate_plan,
)
from repro_torch.core.samplers.base import conditional_plan
from repro_torch.core.samplers.md import MDSampler
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

M, ROUNDS = 10, 50


def _sizes(kind: str) -> np.ndarray:
    if kind == "balanced":
        return np.full(100, 500)
    if kind == "unbalanced":
        return PROFILE
    return np.random.default_rng(3).integers(1, 2000, size=37)


def _groups(sizes: np.ndarray, m: int) -> list:
    """Contiguous oracle groups, each of token mass m·Σn_i <= M (10 groups of
    10 clients on the balanced population)."""
    cap, groups, cur, mass = int(sizes.sum()), [], [], 0
    for i, n_i in enumerate(sizes):
        if mass + m * int(n_i) > cap:
            groups.append(np.array(cur, dtype=np.int64))
            cur, mass = [], 0
        cur.append(i)
        mass += m * int(n_i)
    return groups + [np.array(cur, dtype=np.int64)]


def _kwargs(name: str, sizes: np.ndarray) -> dict:
    if name == "target":
        return {"groups": _groups(sizes, M)}
    if name == "algorithm2":
        return {"update_dim": 16}
    return {}


def _pair(name: str, sizes: np.ndarray, seed: int = 5):
    """The same sampler built in both packages."""
    kw = _kwargs(name, sizes)
    ref = REF_SAMPLERS[name](RefPopulation(sizes), M, seed=seed, **kw)
    if name == "algorithm2":
        kw["device"] = "cpu"
    port = SAMPLERS[name](ClientPopulation(sizes), M, seed=seed, **kw)
    return ref, port


def _assert_plans_equal(got, want):
    np.testing.assert_array_equal(got.r, want.r)
    for field in ("r_tokens", "cluster_of"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_array_equal(g, w)


def test_samplers_registry_is_the_references():
    assert SAMPLERS.names() == REF_SAMPLERS.names()


def test_register_sampler_override_rule():
    with pytest.raises(ValueError, match="'md' is already registered"):
        register_sampler("md", MDSampler)
    try:
        assert register_sampler("md", MDSampler, override=True) is MDSampler
        register_sampler("md_again")(MDSampler)  # decorator form
        assert SAMPLERS["md_again"] is MDSampler
        with pytest.raises(ValueError, match="did you mean 'md_again'"):
            SAMPLERS.get("md_agian")
    finally:
        SAMPLERS.unregister("md_again")
    assert "md_again" not in SAMPLERS


@pytest.mark.parametrize("kind", ["balanced", "unbalanced", "random"])
@pytest.mark.parametrize("name", ["md", "uniform", "algorithm1", "algorithm2", "target"])
def test_draws_bit_equal_reference(name, kind):
    """50 rounds from one seed: clients, agg_weights and stale_weight; for
    Algorithm 2, updates observed every 10 rounds re-cluster both plans."""
    sizes = _sizes(kind)
    ref, port = _pair(name, sizes)
    rng = np.random.default_rng(0)
    try:
        for t in range(ROUNDS):
            want, got = ref.sample(t), port.sample(t)
            np.testing.assert_array_equal(got.clients, want.clients)
            np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
            assert got.stale_weight == want.stale_weight
            if name == "algorithm2" and t % 10 == 9:
                ids = np.unique(want.clients)
                G = (1e-2 * rng.normal(size=(ids.size, 16))).astype(np.float32)
                ref.observe_updates(ids, G)
                port.observe_updates(ids, torch.from_numpy(G))
                _assert_plans_equal(port.plan, ref.plan)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("kind", ["balanced", "unbalanced", "random"])
@pytest.mark.parametrize("name", ["md", "algorithm1", "algorithm2", "target"])
def test_plans_equal_reference(name, kind):
    sizes = _sizes(kind)
    ref, port = _pair(name, sizes)
    try:
        _assert_plans_equal(port.plan, ref.plan)
        validate_plan(port.plan, ClientPopulation(sizes))
        ref_validate_plan(ref.plan, RefPopulation(sizes))
        np.testing.assert_array_equal(max_draws_bound(port.plan), ref_max_draws_bound(ref.plan))
    finally:
        ref.close()
        port.close()


def test_uniform_has_no_plan_and_keeps_stale_mass():
    _, port = _pair("uniform", PROFILE)
    assert port.plan is None and not port.unbiased
    res = port.sample(0)
    assert len(res.clients) == M and res.stale_weight > 0  # eq. (3)
    np.testing.assert_allclose(res.agg_weights.sum() + res.stale_weight, 1.0)


@pytest.mark.parametrize("kind", ["balanced", "unbalanced"])
def test_algorithm1_max_draws_bound(kind):
    """Section 4: client i appears in at most floor(m p_i) + 2 distributions."""
    pop = ClientPopulation(_sizes(kind))
    plan = build_plan_algorithm1(pop, M)
    assert (max_draws_bound(plan) <= np.floor(M * pop.importances) + 2).all()
    if kind == "balanced":  # m divides n: every client in exactly one urn
        assert (max_draws_bound(plan) == 1).all()


def test_target_draws_one_client_a_group():
    pop = ClientPopulation(np.full(100, 500))
    plan = build_plan_target(pop, M, _groups(pop.n_samples, M))
    validate_plan(plan, pop)
    _, port = _pair("target", np.full(100, 500))
    for t in range(20):
        assert sorted(c // 10 for c in port.sample(t).clients) == list(range(M))


def test_algorithm1_telemetry_is_static():
    ref, port = _pair("algorithm1", PROFILE)
    assert port.plan_telemetry() == ref.plan_telemetry() == (0, 0)
    assert port.plan_cost_telemetry()[1] == ref.plan_cost_telemetry()[1] == -1.0
    assert port.plan_cost_telemetry()[0] >= 0.0
    port.close()
    ref.close()


# --------------------------------------------------------------------------
# availability conditioning
# --------------------------------------------------------------------------
def _masks(n: int, rng) -> list:
    """Random masks, the all-true mask, one lone client and the empty mask."""
    lone = np.zeros(n, bool)
    lone[n // 2] = True
    return [rng.random(n) < 0.5, rng.random(n) < 0.9, np.ones(n, bool), lone, np.zeros(n, bool)]


@pytest.mark.parametrize("kind", ["balanced", "unbalanced", "random"])
@pytest.mark.parametrize("name", ["md", "algorithm1", "algorithm2", "target"])
def test_conditional_plan_equals_reference(name, kind):
    sizes = _sizes(kind)
    ref, port = _pair(name, sizes)
    try:
        for a in _masks(len(sizes), np.random.default_rng(1))[:-1]:
            (got_r, got_w), (want_r, want_w) = conditional_plan(port.plan, a), ref_conditional_plan(ref.plan, a)
            np.testing.assert_array_equal(got_r, want_r)
            np.testing.assert_array_equal(got_w, want_w)
        for bad in (np.zeros(len(sizes), bool), np.ones(len(sizes) + 1, bool)):
            with pytest.raises(ValueError) as want:
                ref_conditional_plan(ref.plan, bad)
            with pytest.raises(ValueError) as got:
                conditional_plan(port.plan, bad)
            assert str(got.value) == str(want.value)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("kind", ["balanced", "unbalanced", "random"])
@pytest.mark.parametrize("name", ["md", "uniform", "algorithm1", "algorithm2", "target"])
def test_masked_draws_bit_equal_reference(name, kind):
    """50 rounds under a rotation of masks — random, all-true, one lone
    client, fully masked — plus unmasked rounds between them: clients,
    agg_weights and stale_weight bit-equal, so the uniform stream stays
    aligned through empty rounds too."""
    sizes = _sizes(kind)
    ref, port = _pair(name, sizes)
    rng = np.random.default_rng(0)
    try:
        for t in range(ROUNDS):
            masks = _masks(len(sizes), rng)
            a = None if t % 6 == 5 else masks[t % 6]
            want, got = ref.sample(t, a), port.sample(t, a)
            np.testing.assert_array_equal(got.clients, want.clients)
            np.testing.assert_array_equal(got.agg_weights, want.agg_weights)
            assert got.stale_weight == want.stale_weight
            if a is not None:
                assert (got.agg_weights[~a] == 0).all()
                if not a.any():
                    assert got.clients.size == 0
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("name", ["md", "algorithm1", "target"])
def test_all_true_mask_is_the_unmasked_draw(name):
    sizes = _sizes("balanced")
    _, a = _pair(name, sizes, seed=3)
    _, b = _pair(name, sizes, seed=3)
    for t in range(20):
        x, y = a.sample(t, np.ones(len(sizes), bool)), b.sample(t)
        np.testing.assert_array_equal(x.clients, y.clients)
        np.testing.assert_array_equal(x.agg_weights, y.agg_weights)
    assert a.supports_overselect and b.supports_overselect
