# Copied from src/repro/core/statistics.py.
"""Closed-form sampling statistics from Sections 3.2 / Appendix B.

These are the paper's theoretical quantities; the property tests and the
variance benchmark check realized sampling against them.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import ClientPopulation, SamplingPlan


def md_weight_variance(p: np.ndarray, m: int) -> np.ndarray:
    """eq. (13): Var[ω_i] under MD sampling = p_i (1 - p_i) / m."""
    p = np.asarray(p, dtype=np.float64)
    return p * (1.0 - p) / m


def clustered_weight_variance(plan: SamplingPlan) -> np.ndarray:
    """eq. (16): Var[ω_i] under clustered sampling = (1/m²) Σ_k r_{k,i}(1-r_{k,i})."""
    r = plan.r
    return (r * (1.0 - r)).sum(axis=0) / plan.m**2


def md_inclusion_probability(p: np.ndarray, m: int) -> np.ndarray:
    """eq. (20): P(i ∈ S_MD) = 1 - (1 - p_i)^m."""
    p = np.asarray(p, dtype=np.float64)
    return 1.0 - (1.0 - p) ** m


def clustered_inclusion_probability(plan: SamplingPlan) -> np.ndarray:
    """eq. (22): P(i ∈ S_C) = 1 - Π_k (1 - r_{k,i})."""
    return 1.0 - np.prod(1.0 - plan.r, axis=0)


def variance_reduction(plan: SamplingPlan, population: ClientPopulation) -> np.ndarray:
    """Per-client Var_MD - Var_C ≥ 0 (eq. 17 / Appendix B.1).

    Closed form (eq. 49): (1/m²) [ Σ_k r_{k,i}² - m p_i² ].
    """
    p = population.importances
    m = plan.m
    return ((plan.r**2).sum(axis=0) - m * p**2) / m**2


def expected_distinct_clients(plan: SamplingPlan) -> float:
    """E[#distinct sampled clients] = Σ_i P(i ∈ S)."""
    return float(clustered_inclusion_probability(plan).sum())


def md_prob_all_distinct(p: np.ndarray, m: int) -> float:
    """P(all m MD draws are distinct) — permanent over distinct index tuples.

    For the paper's controlled setting (n=100 uniform clients, m=10) this is
    100!/(90! · 100^10) ≈ 63%. Computed exactly only for uniform ``p``;
    otherwise estimated by inclusion–exclusion is exponential, so we Monte
    Carlo (the tests only use the uniform case).
    """
    p = np.asarray(p, dtype=np.float64)
    n = p.shape[0]
    if np.allclose(p, 1.0 / n):
        # n!/(n-m)! / n^m
        val = 1.0
        for j in range(m):
            val *= (n - j) / n
        return float(val)
    rng = np.random.default_rng(0)
    draws = rng.choice(n, size=(20000, m), p=p)
    distinct = np.array([len(np.unique(row)) == m for row in draws])
    return float(distinct.mean())


def empirical_weight_moments(
    sample_fn, n_clients: int, n_rounds: int
) -> tuple[np.ndarray, np.ndarray]:
    """Monte-Carlo mean/variance of aggregation weights over ``n_rounds`` draws."""
    ws = np.empty((n_rounds, n_clients))
    for t in range(n_rounds):
        ws[t] = sample_fn(t).agg_weights
    return ws.mean(axis=0), ws.var(axis=0)
