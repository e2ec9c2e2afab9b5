# Adapted from src/repro/core/samplers/schemes/stratified.py, on the
# port's store and distance op.
"""Stratified client selection (Shen et al.; FedSTaS lineage).

Strata are formed by a clustering objective over the representative-gradient
store — any :data:`repro_torch.core.clustering.backends.CLUSTERERS` entry — and
the plan allocates each stratum a *contiguous* run of urn capacity exactly
proportional to its data mass, with every client's within-stratum share
proportional to its sample count ``n_i`` (i.e. the within-stratum draw is
uniform over *sample tokens*, the integer-exact reading of "uniform within
the stratum" that keeps eq. (8) satisfiable for unequal client sizes).

Construction: give client ``i`` its ``m·n_i`` sample tokens, order strata by
descending token mass (stable), order clients within a stratum by descending
mass (stable), and pour the whole stream through the Appendix-C sequential
urn filler (``m`` urns of capacity ``M``). Total tokens are exactly ``m·M``,
so the resulting plan satisfies eq. (7)/(8) *exactly* — ``validate_plan``
passes with integer checks, E[ω_i] = p_i, availability conditioning through
``conditional_plan`` stays exactly unbiased over the available set, and the
variance/inclusion theorems (eq. 17/23) apply as to any Proposition-1 plan.

``cluster_of`` records the stratum id per client, so the plan service's
drift trigger (``drift_threshold``) measures assignment churn against the
live strata and restratifies only when the population has actually moved —
FedSTaS-style restratification on drift, for free.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.core.allocation import fill_urns_sequential
from repro_torch.core.clustering.backends import resolve_clusterer
from repro_torch.core.samplers.algorithm2 import DistanceFn, _resolve_distance_fn
from repro_torch.core.samplers.store_backed import StoreBackedSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan


def default_n_strata(n: int) -> int:
    """The √n heuristic (≥ 2 strata when the population allows it)."""
    return int(min(n, max(2, round(math.sqrt(n)))))


def build_plan_stratified(
    population: ClientPopulation,
    m: int,
    G,
    *,
    n_strata: Optional[int] = None,
    clusterer: Union[Callable, str] = "ward",
    measure: str = "arccos",
    distance_fn: Union[DistanceFn, str, None] = None,
    seed: int = 0,
) -> SamplingPlan:
    """Stratify by the clustering objective, then stream strata into urns.

    The clusterer is called with ``m = n_strata`` and capacity ``m·M`` — no
    per-group mass cap (a stratum may exceed one urn and spill contiguously
    into the next), so *any* partition the backend produces is feasible.
    The clusterer may return more than ``n_strata`` groups (capacity-repair
    backends do); each returned group is simply its own stratum.
    ``distance_fn`` is a backend name (``None``, the default, and
    ``"numpy"`` are the f64 host measure; ``"auto"`` and the reference's
    other device names are the similarity op on G's device) or a callable
    ``(G, measure) -> (n, n)``.
    """
    n = population.n_clients
    M = population.total_samples
    mass = m * population.n_samples  # m·n_i tokens per client
    k = default_n_strata(n) if n_strata is None else int(n_strata)
    if not 1 <= k <= n:
        raise ValueError(f"n_strata must be in [1, n={n}], got {k}")

    groups = resolve_clusterer(clusterer)(
        G,
        mass,
        k,
        m * M,
        measure=measure,
        distance_fn=_resolve_distance_fn(distance_fn),
        seed=seed,
    )
    groups = [np.asarray(g, dtype=np.int64) for g in groups]
    q = np.array([int(mass[g].sum()) for g in groups], dtype=np.int64)
    order = np.argsort(-q, kind="stable")  # descending stratum mass

    cluster_of = np.full(n, -1, dtype=np.int64)
    for sid, gi in enumerate(order):
        cluster_of[groups[gi]] = sid

    def stream():
        for gi in order:
            g = groups[gi]
            for i in g[np.argsort(-mass[g], kind="stable")]:
                yield int(i), int(mass[i])

    tokens = fill_urns_sequential(stream(), n, m, M)
    return SamplingPlan(r=tokens / M, r_tokens=tokens, cluster_of=cluster_of)


class StratifiedSampler(StoreBackedSampler):
    """Stratified selection with drift-triggered restratification.

    Strata live in the same device-resident (possibly sketched) gradient
    store as Algorithm 2 and rebuild through the same plan service — sync or
    async, on a cadence or on measured assignment drift. Only the plan
    construction differs: proportional-allocation strata instead of
    capacity-capped similarity clusters.
    """

    scheme_name = "stratified"

    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        update_dim: int,
        *,
        n_strata: Optional[int] = None,
        measure: str = "arccos",
        distance_fn: Union[DistanceFn, str, None] = "auto",
        clusterer: Union[Callable, str] = "ward",
        seed: int = 0,
        staleness_decay: float = 1.0,
        planner: str = "sync",
        rebuild_every: int = 1,
        drift_threshold: Optional[float] = None,
        sketch: Optional[str] = None,
        sketch_dim: Optional[int] = None,
        store_mesh_spec=None,
        device="cuda",
    ):
        """``n_strata`` defaults to the √n heuristic. All other knobs have
        Algorithm 2's semantics (see
        :class:`~repro_torch.core.samplers.algorithm2.Algorithm2Sampler`);
        ``device`` holds the gradient store, and the default ``"cuda"``
        raises without a GPU."""
        self.n_strata = None if n_strata is None else int(n_strata)
        self.measure = measure
        self._distance_fn = _resolve_distance_fn(distance_fn)
        self._clusterer = clusterer
        self._clusterer_seed = int(seed)
        super().__init__(
            population,
            m,
            update_dim,
            seed=seed,
            staleness_decay=staleness_decay,
            planner=planner,
            rebuild_every=rebuild_every,
            drift_threshold=drift_threshold,
            sketch=sketch,
            sketch_dim=sketch_dim,
            store_mesh_spec=store_mesh_spec,
            device=device,
        )

    def _build_plan(self, G) -> SamplingPlan:
        return build_plan_stratified(
            self.population,
            self.m,
            G,
            n_strata=self.n_strata,
            clusterer=self._clusterer,
            measure=self.measure,
            distance_fn=self._distance_fn,
            seed=self._clusterer_seed,
        )
