# Adapted from src/repro/core/samplers/schemes/hybrid.py, on the port's
# store and distance op.
"""Hybrid selection: deterministic head + stratified tail (Shen et al.).

High-mass clients (``p_i ≥ 1/m``) are selected deterministically — client
``i`` owns ``floor(m·p_i)`` dedicated probability-1 urns, exactly the
Section-5 large-client head Algorithm 2 uses — and the remaining *tail*
mass (every client's remainder after its dedicated urns) is sampled via
the stratified scheme over the remaining urns: strata from the clustering
objective over the pool clients' gradients, poured mass-proportionally
through the sequential urn filler.

Total tokens are again exactly ``m·M`` (head urns hold ``M`` each, the pool
stream holds ``m_pool·M``), so the plan satisfies eq. (7)/(8) exactly with
all the downstream guarantees. When *no* client reaches ``p_i ≥ 1/m`` the
head is empty and the plan equals :func:`build_plan_stratified` on the same
gradients token-for-token (pinned by test), so ``hybrid`` is a strict
generalization of ``stratified`` to head-heavy populations.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from repro_torch.core.allocation import fill_urns_sequential
from repro_torch.core.clustering.backends import resolve_clusterer
from repro_torch.core.samplers.algorithm2 import DistanceFn, _resolve_distance_fn
from repro_torch.core.samplers.schemes.stratified import default_n_strata
from repro_torch.core.samplers.store_backed import StoreBackedSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan


def build_plan_hybrid(
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
    """Dedicated urns for the ``floor(m·p_i)`` head, stratified tail."""
    n = population.n_clients
    M = population.total_samples
    mass = m * population.n_samples  # m·n_i tokens per client

    # --- deterministic head: probability-1 urns ------------------------------
    full_urns = (mass // M).astype(np.int64)  # floor(m·p_i) per client
    pool_mass = mass - full_urns * M  # remainder joins the stratified tail
    m_pool = m - int(full_urns.sum())
    if m_pool < 0:
        raise ValueError("impossible: sum floor(m p_i) > m")

    tokens = np.zeros((m, n), dtype=np.int64)
    owners = np.repeat(np.arange(n), full_urns)  # urn k -> its dedicated client
    tokens[np.arange(owners.size), owners] = M

    cluster_of = np.full(n, -1, dtype=np.int64)
    if m_pool > 0:
        pool = np.flatnonzero(pool_mass > 0)
        k = default_n_strata(int(pool.size)) if n_strata is None else int(n_strata)
        k = max(1, min(k, int(pool.size)))
        groups_local = resolve_clusterer(clusterer)(
            G[pool],
            pool_mass[pool],
            k,
            m_pool * M,  # no per-stratum cap: strata spill across urns
            measure=measure,
            distance_fn=_resolve_distance_fn(distance_fn),
            seed=seed,
        )
        groups = [pool[np.asarray(g, dtype=np.int64)] for g in groups_local]
        q = np.array([int(pool_mass[g].sum()) for g in groups], dtype=np.int64)
        order = np.argsort(-q, kind="stable")
        for sid, gi in enumerate(order):
            cluster_of[groups[gi]] = sid

        def stream():
            for gi in order:
                g = groups[gi]
                for i in g[np.argsort(-pool_mass[g], kind="stable")]:
                    yield int(i), int(pool_mass[i])

        # head urns sit at capacity, so the pool stream fills urns m-m_pool..m
        tokens = fill_urns_sequential(stream(), n, m, M, initial=tokens)

    return SamplingPlan(r=tokens / M, r_tokens=tokens, cluster_of=cluster_of)


class HybridSampler(StoreBackedSampler):
    """Deterministic high-mass head + stratified tail over the shared store."""

    scheme_name = "hybrid"

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
        """Knob semantics follow :class:`StratifiedSampler` (``n_strata``
        applies to the *pool* clients after the head is split off)."""
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
        return build_plan_hybrid(
            self.population,
            self.m,
            G,
            n_strata=self.n_strata,
            clusterer=self._clusterer,
            measure=self.measure,
            distance_fn=self._distance_fn,
            seed=self._clusterer_seed,
        )
