# Adapted from src/repro/core/samplers/algorithm2.py: build_plan_algorithm2
# without the availability mask (cluster_mask); Algorithm2Sampler in torch.
"""Algorithm 2 — clustered sampling based on model similarity (Section 5).

Pipeline per re-clustering round:
  1. similarity matrix over representative gradients ``G_i = θ_i - θ``
     (the CUDA similarity kernel on the GPU, its plain version on the CPU),
  2. Ward hierarchical clustering,
  3. cut into K >= m groups with mass q_k <= M,
  4. cluster-seeded urn filling -> ``r`` matrix.

Clients never sampled yet carry a constant 0 representative gradient, so
they cluster together and get promoted jointly (the paper's cold-start
rule). Clients with ``p_i >= 1/m`` receive ``floor(m p_i)`` dedicated
probability-1 distributions, their remainder mass joining the common pool
(final remark of Section 5).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np

from repro_torch.core.allocation import allocate_by_groups
from repro_torch.core.clustering.backends import resolve_clusterer
from repro_torch.core.samplers.store_backed import StoreBackedSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan

# pairwise-distance backend signature: (G, measure) -> (n, n) distances
# (a tensor on G's device, or a numpy array)
DistanceFn = Callable[[object, str], np.ndarray]

# clusterer signature: see repro_torch.core.clustering.backends
ClustererFn = Callable[..., list]


def _resolve_distance_fn(distance_fn: Union[DistanceFn, str]) -> DistanceFn:
    """Map the sampler's ``distance_fn`` argument to a callable: ``"auto"``
    is the port's similarity op (the CUDA kernel for a CUDA G, its plain
    version for a CPU G), whose (n, n) output stays on G's device for the
    clusterer to take (``"ward"`` copies it to the host, ``"ward_jit"``
    does not); a callable passes through."""
    if callable(distance_fn):
        return distance_fn
    if distance_fn != "auto":
        raise ValueError(f"unknown distance backend {distance_fn!r}; pass 'auto' or a callable")
    from repro_torch.kernels.similarity.ops import make_distance_fn

    return make_distance_fn()


def build_plan_algorithm2(
    population: ClientPopulation,
    m: int,
    G,
    *,
    measure: str = "arccos",
    distance_fn: Union[DistanceFn, str] = "auto",
    clusterer: Union[ClustererFn, str] = "ward",
    clusterer_seed: int = 0,
) -> SamplingPlan:
    """Build the similarity-clustered ``r`` matrix for one round.

    ``G`` is passed to the clustering backend untouched — a device tensor
    stays on the device through the O(n²d) distance stage; only the (n, n)
    distances (``"ward"``) or linkage rows (``"ward_jit"``) or labels
    (``"kmeans"``) come back to the host for the cut and the urn
    construction. ``distance_fn`` is ``"auto"`` (the similarity kernel) or
    a callable ``(G, measure) -> (n, n)``; ``clusterer`` names a
    :data:`repro_torch.core.clustering.backends.CLUSTERERS` entry
    (``"ward"``, ``"ward_jit"``, ``"kmeans"``) or is a callable with the
    same signature.
    """
    n = population.n_clients
    M = population.total_samples
    mass = m * population.n_samples  # m * n_i tokens per client

    # --- large clients: dedicated probability-1 urns --------------------
    full_urns = (mass // M).astype(np.int64)  # floor(m p_i) per client
    pool_mass = mass - full_urns * M  # remainder joins the pool
    m_pool = m - int(full_urns.sum())
    if m_pool < 0:
        raise ValueError("impossible: sum floor(m p_i) > m")

    tokens = np.zeros((m, n), dtype=np.int64)
    owners = np.repeat(np.arange(n), full_urns)  # urn k -> its dedicated client
    tokens[np.arange(owners.size), owners] = M
    urn = int(owners.size)

    cluster_of = np.full(n, -1, dtype=np.int64)
    if m_pool > 0:
        pool = np.flatnonzero(pool_mass > 0)
        groups_local = resolve_clusterer(clusterer)(
            G[pool],
            pool_mass[pool],
            m_pool,
            M,
            measure=measure,
            distance_fn=_resolve_distance_fn(distance_fn),
            seed=clusterer_seed,
        )
        groups = [pool[g] for g in groups_local]
        for gid, g in enumerate(groups):
            cluster_of[g] = gid
        tokens[urn:, :] = allocate_by_groups(pool_mass, m_pool, M, groups)

    return SamplingPlan(r=tokens / M, r_tokens=tokens, cluster_of=cluster_of)


class Algorithm2Sampler(StoreBackedSampler):
    """Similarity-based clustered sampling with online re-clustering.

    The latest representative gradient of every client (zeros until first
    sampled) lives in a device-resident gradient store on ``device``;
    observing a round's updates scatters them in and hands a snapshot to the
    plan service, which rebuilds the plan inline (``planner="sync"``) or on a
    background worker (``planner="async"``). The freshest completed plan is
    swapped in at each round boundary.
    """

    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        update_dim: int,
        *,
        measure: str = "arccos",
        seed: int = 0,
        distance_fn: Union[DistanceFn, str] = "auto",
        clusterer: Union[ClustererFn, str] = "ward",
        staleness_decay: float = 1.0,
        planner: str = "sync",
        rebuild_every: int = 1,
        drift_threshold: Optional[float] = None,
        sketch: Optional[str] = None,
        sketch_dim: Optional[int] = None,
        device="cuda",
    ):
        """``distance_fn`` selects the O(n²d) pairwise-distance backend:
        ``"auto"`` (the CUDA similarity kernel on a CUDA store, its plain
        version on a CPU store) or a callable.
        ``clusterer`` names a ``CLUSTERERS`` entry (``"ward"``,
        ``"ward_jit"``, ``"kmeans"``) or is a callable. ``staleness_decay``,
        ``planner``, ``rebuild_every`` and ``drift_threshold`` are as in the
        reference sampler. ``sketch`` / ``sketch_dim`` attach the store's
        sketch stage (a ``SKETCHERS`` name: ``"srp"``, ``"countsketch"``,
        or ``"identity"``, bit for bit the unsketched store), seeded with
        ``seed``: the engine's (c, d) updates are compressed to (c, d')
        before the scatter, so the store, the similarity stage and the
        clusterers work in sketch space. ``device`` holds the gradient
        store; the default ``"cuda"`` raises without a GPU."""
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
            device=device,
        )

    def _build_plan(self, G) -> SamplingPlan:
        return build_plan_algorithm2(
            self.population,
            self.m,
            G,
            measure=self.measure,
            distance_fn=self._distance_fn,
            clusterer=self._clusterer,
            clusterer_seed=self._clusterer_seed,
        )
