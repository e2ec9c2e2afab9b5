"""The port's closed-form statistics against the JAX package's, and the
paper's theorems (eq. 17 variance reduction, eq. 23 inclusion) and the
availability-conditioned unbiasedness of every scheme on the port's
plans."""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import SAMPLERS as REF_SAMPLERS
from repro.core import ClientPopulation as RefPopulation
from repro.core import statistics as ref_stats
from repro_torch.benchmarks.table_variance import PROFILE
from repro_torch.core import (
    SAMPLERS,
    Algorithm1Sampler,
    ClientPopulation,
    SamplingPlan,
    build_plan_algorithm1,
    build_plan_algorithm2,
    build_plan_hybrid,
    build_plan_stratified,
    validate_plan,
)
from repro_torch.core import statistics as stats
from repro_torch.core.samplers.base import conditional_plan
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

M = 10
PLAN_STATS = (
    "clustered_weight_variance",
    "clustered_inclusion_probability",
    "expected_distinct_clients",
)
GROUPS = [np.arange(i * 10, (i + 1) * 10) for i in range(10)]


def _pair(name: str, sizes: np.ndarray):
    kw = {"target": {"groups": GROUPS}, "algorithm2": {"update_dim": 16}}.get(name, {})
    ref = REF_SAMPLERS[name](RefPopulation(sizes), M, seed=2, **kw)
    if name == "algorithm2":
        kw = {**kw, "device": "cpu"}
    port = SAMPLERS[name](ClientPopulation(sizes), M, seed=2, **kw)
    if name == "algorithm2":  # re-cluster both from the same gradients
        G = (1e-2 * np.random.default_rng(1).normal(size=(len(sizes), 16))).astype(np.float32)
        ids = np.arange(len(sizes))
        ref.observe_updates(ids, G)
        port.observe_updates(ids, torch.from_numpy(G))
    return ref, port


SIZES = {"balanced": np.full(100, 500), "unbalanced": PROFILE}
# the oracle's groups of 10 clients carry M tokens each on balanced sizes only
CASES = [(n, k) for n in ("md", "algorithm1", "algorithm2") for k in SIZES] + [("target", "balanced")]


@pytest.mark.parametrize("name,kind", CASES)
def test_statistics_equal_reference(name, kind):
    sizes = SIZES[kind]
    ref, port = _pair(name, sizes)
    try:
        for fn in PLAN_STATS:
            np.testing.assert_array_equal(getattr(stats, fn)(port.plan),
                                          getattr(ref_stats, fn)(ref.plan))
        np.testing.assert_array_equal(
            stats.variance_reduction(port.plan, ClientPopulation(sizes)),
            ref_stats.variance_reduction(ref.plan, RefPopulation(sizes)),
        )
        p = ClientPopulation(sizes).importances
        for fn in ("md_weight_variance", "md_inclusion_probability"):
            np.testing.assert_array_equal(getattr(stats, fn)(p, M), getattr(ref_stats, fn)(p, M))
        assert stats.md_prob_all_distinct(p, M) == ref_stats.md_prob_all_distinct(p, M)
        # Monte-Carlo moments of 200 draws: the same draws, so the same numbers
        for got, want in zip(stats.empirical_weight_moments(port.sample, len(sizes), 200),
                             ref_stats.empirical_weight_moments(ref.sample, len(sizes), 200)):
            np.testing.assert_array_equal(got, want)
    finally:
        ref.close()
        port.close()


populations = st.lists(st.integers(min_value=1, max_value=2000), min_size=6, max_size=60)
ms = st.integers(min_value=2, max_value=12)


@given(populations, ms)
@settings(max_examples=40, deadline=None)
def test_algorithm1_variance_and_inclusion_theorems(ns, m):
    pop = ClientPopulation(np.array(ns))
    plan = build_plan_algorithm1(pop, m)
    validate_plan(plan, pop)
    p = pop.importances
    assert (stats.clustered_weight_variance(plan) <= stats.md_weight_variance(p, m) + 1e-12).all()
    assert (stats.variance_reduction(plan, pop) >= -1e-12).all()
    q_c = stats.clustered_inclusion_probability(plan)
    assert (q_c >= stats.md_inclusion_probability(p, m) - 1e-12).all()


@given(populations, ms, st.integers(min_value=0, max_value=10_000))
@settings(max_examples=25, deadline=None)
def test_algorithm2_theorems_random_gradients(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    G = np.random.default_rng(seed).normal(size=(pop.n_clients, 6)).astype(np.float32)
    plan = build_plan_algorithm2(pop, m, torch.from_numpy(G))
    validate_plan(plan, pop)
    p = pop.importances
    assert (stats.clustered_weight_variance(plan) <= stats.md_weight_variance(p, m) + 1e-12).all()
    assert (stats.variance_reduction(plan, pop) >= -1e-12).all()
    assert (
        stats.clustered_inclusion_probability(plan)
        >= stats.md_inclusion_probability(p, m) - 1e-12
    ).all()


@given(populations, ms)
@settings(max_examples=25, deadline=None)
def test_equality_iff_md(ns, m):
    """MD sampling (r_k = p ∀k) achieves exact equality in both bounds."""
    pop = ClientPopulation(np.array(ns))
    plan = SamplingPlan(r=np.tile(pop.importances, (m, 1)))
    p = pop.importances
    np.testing.assert_allclose(stats.clustered_weight_variance(plan), stats.md_weight_variance(p, m))
    np.testing.assert_allclose(
        stats.clustered_inclusion_probability(plan), stats.md_inclusion_probability(p, m)
    )


@given(populations, ms)
@settings(max_examples=25, deadline=None)
def test_md_and_algorithm1_are_unbiased_in_closed_form(ns, m):
    """eq. (12): E[ω_i] = Σ_k r_ki / m = p_i for the MD and Algorithm 1 plans."""
    pop = ClientPopulation(np.array(ns))
    for name in ("md", "algorithm1"):
        plan = SAMPLERS[name](pop, m).plan
        np.testing.assert_allclose(plan.r.sum(axis=0) / m, pop.importances, atol=1e-12)


def test_closed_form_variance_matches_monte_carlo():
    """eq. (16) against realized sampling for the port's Algorithm 1."""
    pop = ClientPopulation(np.array([100, 250, 500, 750, 1000] * 4))
    s = Algorithm1Sampler(pop, 6, seed=0)
    ws = np.stack([s.sample(t).agg_weights for t in range(6000)])
    np.testing.assert_allclose(ws.var(axis=0), stats.clustered_weight_variance(s.plan), atol=5e-4)
    np.testing.assert_allclose(ws.mean(axis=0), pop.importances, atol=4e-3)


def test_distinct_clients_probability_paper_number():
    """Section 6: with n=100 uniform, m=10, P(10 distinct) = 100!/(90!·100¹⁰) ≈ 63%."""
    import math

    exact = math.factorial(100) / (math.factorial(90) * 100**10)
    assert abs(stats.md_prob_all_distinct(np.full(100, 0.01), 10) - exact) < 1e-12
    assert abs(exact - 0.6282) < 1e-3


# --------------------------------------------------------------------------
# availability-conditioned unbiasedness and the scheme zoo, on the port's
# plans (the properties of tests/test_statistics_property.py)
# --------------------------------------------------------------------------
masks = st.integers(min_value=0, max_value=10_000)


def _conditional_expected_weights(plan, a):
    """E[ω_i | available] in closed form: Σ_k w_k·r̃_ki over the port's
    ``conditional_plan``."""
    r_cond, w = conditional_plan(plan, a)
    return (w[:, None] * r_cond).sum(axis=0)


def _random_mask(n, seed, p_avail=0.6):
    rng = np.random.default_rng(seed)
    a = rng.random(n) < p_avail
    if not a.any():
        a[rng.integers(n)] = True
    return a


def _gradients(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 6)).astype(np.float32))


def _target(p, a):
    return p * a / (p * a).sum()


@given(populations, ms, masks)
@settings(max_examples=30, deadline=None)
def test_availability_conditioned_unbiasedness_algorithm1(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    plan = build_plan_algorithm1(pop, m)
    a = _random_mask(pop.n_clients, seed)
    expect = _conditional_expected_weights(plan, a)
    np.testing.assert_allclose(expect, _target(pop.importances, a), atol=1e-12)
    assert (expect[~a] == 0).all()
    np.testing.assert_allclose(expect.sum(), 1.0, atol=1e-12)


@given(populations, ms, masks)
@settings(max_examples=20, deadline=None)
def test_masked_rebuild_keeps_eq8_and_stays_unbiased(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    cmask = _random_mask(pop.n_clients, seed + 7, p_avail=0.5)
    plan = build_plan_algorithm2(pop, m, _gradients(pop.n_clients, seed), cluster_mask=cmask)
    validate_plan(plan, pop)
    np.testing.assert_array_equal(plan.r_tokens.sum(axis=0), m * pop.n_samples)
    np.testing.assert_array_equal(plan.r_tokens.sum(axis=1), np.full(m, pop.total_samples))
    pool = np.flatnonzero(m * pop.n_samples % pop.total_samples > 0)
    if not cmask.all() and cmask[pool].any():
        assert (plan.cluster_of[~cmask] == -1).all()
    a = _random_mask(pop.n_clients, seed + 13)
    np.testing.assert_allclose(_conditional_expected_weights(plan, a),
                               _target(pop.importances, a), atol=1e-12)


@given(populations, ms, masks)
@settings(max_examples=20, deadline=None)
def test_availability_conditioned_unbiasedness_algorithm2_and_md(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    a = _random_mask(pop.n_clients, seed + 1)
    p = pop.importances
    for plan in (build_plan_algorithm2(pop, m, _gradients(pop.n_clients, seed)),
                 SamplingPlan(r=np.tile(p, (m, 1)))):
        np.testing.assert_allclose(_conditional_expected_weights(plan, a), _target(p, a), atol=1e-12)


def test_conditional_draw_monte_carlo_matches_expectation():
    pop = ClientPopulation(np.array([100, 250, 500, 750, 1000] * 3))
    s = Algorithm1Sampler(pop, 6, seed=0)
    a = _random_mask(pop.n_clients, seed=5)
    ws = np.stack([s.sample(t, a).agg_weights for t in range(8000)])
    np.testing.assert_allclose(ws.sum(axis=1), 1.0, atol=1e-12)
    assert (ws[:, ~a] == 0).all()
    np.testing.assert_allclose(ws.mean(axis=0), _conditional_expected_weights(s.plan, a), atol=5e-3)


@given(populations, ms, st.integers(min_value=0, max_value=10_000))
@settings(max_examples=25, deadline=None)
def test_stratified_and_hybrid_plans_satisfy_all_theorems(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    G = _gradients(pop.n_clients, seed)
    p = pop.importances
    for build in (build_plan_stratified, build_plan_hybrid):
        plan = build(pop, m, G, seed=seed)
        validate_plan(plan, pop)
        np.testing.assert_allclose(plan.r.sum(axis=0) / plan.m, p, atol=1e-12)
        np.testing.assert_allclose(plan.r.sum(axis=1), 1.0, atol=1e-12)
        assert (stats.clustered_weight_variance(plan) <= stats.md_weight_variance(p, m) + 1e-12).all()


@given(populations, ms, masks)
@settings(max_examples=20, deadline=None)
def test_stratified_and_hybrid_availability_conditioned_unbiasedness(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    G = _gradients(pop.n_clients, seed)
    a = _random_mask(pop.n_clients, seed + 1)
    for build in (build_plan_stratified, build_plan_hybrid):
        expect = _conditional_expected_weights(build(pop, m, G, seed=seed), a)
        np.testing.assert_allclose(expect, _target(pop.importances, a), atol=1e-12)
        assert (expect[~a] == 0).all()


@given(populations, ms, st.integers(min_value=0, max_value=10_000))
@settings(max_examples=15, deadline=None)
def test_dp_stratified_plans_stay_exactly_unbiased(ns, m, seed):
    pop = ClientPopulation(np.array(ns))
    s = SAMPLERS["dp_stratified"](pop, m, 6, noise_multiplier=float(10.0 ** (seed % 5 - 2)),
                                  seed=seed, device="cpu")
    try:
        s.observe_updates(np.arange(pop.n_clients), _gradients(pop.n_clients, seed))
        s.sample(0)
        plan = s.plan
    finally:
        s.close()
    validate_plan(plan, pop)
    np.testing.assert_allclose(plan.r.sum(axis=0) / plan.m, pop.importances, atol=1e-12)
    a = _random_mask(pop.n_clients, seed + 1)
    np.testing.assert_allclose(_conditional_expected_weights(plan, a),
                               _target(pop.importances, a), atol=1e-12)


@given(populations, ms, masks, st.floats(min_value=0.05, max_value=1.0))
@settings(max_examples=20, deadline=None)
def test_importance_expected_weights_exact(ns, m, seed, mix):
    pop = ClientPopulation(np.array(ns))
    s = SAMPLERS["importance"](pop, m, 6, mix=float(mix), seed=seed, device="cpu")
    try:
        s.observe_updates(np.arange(pop.n_clients), _gradients(pop.n_clients, seed))
        s.sample(0)
        q, p = s.plan.r[0], pop.importances
        np.testing.assert_allclose(q * s.correction(), p, atol=1e-12)
        a = _random_mask(pop.n_clients, seed + 1)
        expect = (q * a / (q * a).sum()) * s.correction(a)
        np.testing.assert_allclose(expect, _target(p, a), atol=1e-12)
    finally:
        s.close()
