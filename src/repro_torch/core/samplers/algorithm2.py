# Adapted from src/repro/core/samplers/algorithm2.py: Algorithm2Sampler in
# torch, without the sharded store.
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
import torch

from repro_torch.core.allocation import allocate_by_groups
from repro_torch.core.clustering.backends import resolve_clusterer
from repro_torch.core.samplers.store_backed import StoreBackedSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan

# pairwise-distance backend signature: (G, measure) -> (n, n) distances
# (a tensor on G's device, or a numpy array)
DistanceFn = Callable[[object, str], np.ndarray]

# clusterer signature: see repro_torch.core.clustering.backends
ClustererFn = Callable[..., list]


def _resolve_distance_fn(
    distance_fn: Union[DistanceFn, str, None], *, as_numpy: bool = False
) -> DistanceFn:
    """Map the sampler's ``distance_fn`` argument to a callable.

    A callable passes through; ``None`` is the f64 host measure; a name is
    resolved by :func:`repro_torch.kernels.similarity.ops.
    resolve_distance_backend`, which takes every name the reference takes.
    The device backends' (n, n) output stays on G's device for the
    clusterer to take (``"ward"`` copies it to the host, ``"ward_jit"``
    does not).
    """
    if callable(distance_fn):
        return distance_fn
    from repro_torch.kernels.similarity.ops import resolve_distance_backend

    return resolve_distance_backend("numpy" if distance_fn is None else distance_fn,
                                    as_numpy=as_numpy)


def _fit_chunks(ids: np.ndarray, mass: np.ndarray, capacity: int) -> list[np.ndarray]:
    """Greedy first-fit packing of ``ids`` into chunks of mass <= capacity.

    Every pool client's remainder mass is < M by construction (it is
    ``m·n_i mod M``), so each singleton fits and the greedy pass always
    succeeds; the chunk count is at most twice the optimum, which only
    costs a few extra (still feasible) groups.
    """
    chunks: list[np.ndarray] = []
    cur: list[int] = []
    cur_mass = 0
    for i in ids:
        mi = int(mass[i])
        if cur and cur_mass + mi > capacity:
            chunks.append(np.asarray(cur, dtype=np.int64))
            cur, cur_mass = [], 0
        cur.append(int(i))
        cur_mass += mi
    if cur:
        chunks.append(np.asarray(cur, dtype=np.int64))
    return chunks


def build_plan_algorithm2(
    population: ClientPopulation,
    m: int,
    G,
    *,
    measure: str = "arccos",
    distance_fn: Union[DistanceFn, str, None] = "auto",
    clusterer: Union[ClustererFn, str] = "ward",
    clusterer_seed: int = 0,
    cluster_mask: Optional[np.ndarray] = None,
) -> SamplingPlan:
    """Build the similarity-clustered ``r`` matrix for one round.

    ``G`` is passed to the clustering backend untouched — a device tensor
    stays on the device through the O(n²d) distance stage; only the (n, n)
    distances (``"ward"``) or linkage rows (``"ward_jit"``) or labels
    (``"kmeans"``) come back to the host for the cut and the urn
    construction. ``distance_fn`` is a backend name (see
    :func:`_resolve_distance_fn`) or a callable ``(G, measure) -> (n, n)``; ``clusterer`` names a
    :data:`repro_torch.core.clustering.backends.CLUSTERERS` entry
    (``"ward"``, ``"ward_jit"``, ``"kmeans"``) or is a callable with the
    same signature.

    ``cluster_mask`` ((n,) bool, optional) restricts the expensive
    *similarity clustering* to the masked-in clients — the FedSTaS-style
    restratification over the recently-available fleet. Masked-out pool
    clients keep their exact eq. (8) token mass but are packed into greedy
    capacity-feasible filler groups (``cluster_of = -1``) instead of riding
    the O(n²d + n³) pipeline. Because every group still carries <= M tokens
    over the same ``m_pool·M`` total, the allocation stays a valid eq. (8)
    plan — Proposition 1 exactness and ``conditional_plan`` unbiasedness
    over any availability mask hold regardless of the mask that built it.
    A degenerate mask (all-in, or excluding every pool client) falls back
    to the unrestricted build.
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
        mask = None
        if cluster_mask is not None:
            cm = np.asarray(cluster_mask, dtype=bool)
            if cm.shape != (n,):
                raise ValueError(f"cluster_mask shape {cm.shape} != ({n},)")
            if not cm.all() and cm[pool].any():
                mask = cm
        cluster = resolve_clusterer(clusterer)
        if mask is None:
            clustered, chunks = pool, []
            m_target = m_pool
        else:
            clustered = pool[mask[pool]]
            chunks = _fit_chunks(pool[~mask[pool]], pool_mass, M)
            # the clusterer needs >= 1 target group and cannot cut more
            # groups than it has clients; feasibility of the combined
            # grouping is automatic (every group <= M over m_pool·M total
            # mass forces K >= m_pool)
            m_target = max(1, min(clustered.size, m_pool - len(chunks)))
        groups_local = cluster(
            G[clustered],
            pool_mass[clustered],
            m_target,
            M,
            measure=measure,
            distance_fn=_resolve_distance_fn(distance_fn),
            seed=clusterer_seed,
        )
        groups = [clustered[g] for g in groups_local]
        for gid, g in enumerate(groups):
            cluster_of[g] = gid  # filler chunks stay -1: not similarity groups
        pool_tokens = allocate_by_groups(pool_mass, m_pool, M, groups + chunks)
        tokens[urn:, :] = pool_tokens

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

    scheme_name = "algorithm2"

    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        update_dim: int,
        *,
        measure: str = "arccos",
        seed: int = 0,
        distance_fn: Union[DistanceFn, str, None] = "auto",
        clusterer: Union[ClustererFn, str] = "ward",
        staleness_decay: float = 1.0,
        planner: str = "sync",
        rebuild_every: int = 1,
        drift_threshold: Optional[float] = None,
        sketch: Optional[str] = None,
        sketch_dim: Optional[int] = None,
        store_mesh_spec=None,
        device="cuda",
    ):
        """``distance_fn`` selects the O(n²d) pairwise-distance backend:
        ``"auto"`` (the CUDA similarity kernel on a CUDA store, its plain
        version on a CPU store; the reference's other device names map to
        the same op), ``None`` / ``"numpy"`` (the f64 host measure) or a
        callable.
        ``clusterer`` names a ``CLUSTERERS`` entry (``"ward"``,
        ``"ward_jit"``, ``"kmeans"``) or is a callable. ``staleness_decay``,
        ``planner``, ``rebuild_every`` and ``drift_threshold`` are as in the
        reference sampler. ``sketch`` / ``sketch_dim`` attach the store's
        sketch stage (a ``SKETCHERS`` name: ``"srp"``, ``"countsketch"``,
        or ``"identity"``, bit for bit the unsketched store), seeded with
        ``seed``: the engine's (c, d) updates are compressed to (c, d')
        before the scatter, so the store, the similarity stage and the
        clusterers work in sketch space. ``store_mesh_spec`` splits the
        store's client axis over a device mesh (any ``FLConfig.mesh_spec``
        form; its lead device is ``device``). ``device`` holds the gradient
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
            store_mesh_spec=store_mesh_spec,
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
            # None unless an AvailabilityTracker is attached; read at build
            # time (the tracker replaces its score tensor, never mutates it,
            # so the async worker sees a consistent mask)
            cluster_mask=self._cluster_mask(),
        )
