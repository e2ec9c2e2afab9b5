"""Clustering backends behind the ``CLUSTERERS`` registry.

Port of ``src/repro/core/clustering/backends.py``. A clusterer has the
signature

    clusterer(G, token_mass, m, capacity, *,
              measure="arccos", distance_fn, seed=0) -> list[ndarray]

where ``G`` is the (n_pool, d) representative-gradient block (a device
tensor stays on the device), ``distance_fn(G, measure)`` returns the
(n, n) distances (the port's similarity op, see
``repro_torch.kernels.similarity.ops``), ``token_mass[i] = m·n_i`` and
``capacity = M``. The return is a list of disjoint local-index arrays
covering ``0..n_pool-1``, each of token mass <= ``capacity``.

Built-ins:

* ``"ward"``     — numpy Lance–Williams + dendrogram cut, the paper's path;
* ``"ward_jit"`` — the same recurrence on the distances' device
  (:func:`repro_torch.core.clustering.device.ward_linkage_device`);
* ``"kmeans"``   — Lloyd over G on its device (no (n, n) matrix), then a
  host capacity repair that splits over-cap and too-few groups.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering.device import kmeans_labels, ward_linkage_device
from repro_torch.core.clustering.tree import cut_tree
from repro_torch.core.clustering.ward import ward_linkage
from repro_torch.core.registry import Registry


def ward_clusters(
    G,
    token_mass: np.ndarray,
    m: int,
    capacity: int,
    *,
    measure: str = "arccos",
    distance_fn,
    seed: int = 0,
):
    """Numpy Ward + dendrogram cut over ``distance_fn``'s distances — the
    paper-faithful path."""
    del seed  # deterministic
    dist = distance_fn(G, measure)
    dist = dist.cpu().numpy() if isinstance(dist, torch.Tensor) else np.asarray(dist)
    link = ward_linkage(dist)
    return cut_tree(link, int(G.shape[0]), m, token_mass, capacity)


def ward_jit_clusters(
    G,
    token_mass: np.ndarray,
    m: int,
    capacity: int,
    *,
    measure: str = "arccos",
    distance_fn,
    seed: int = 0,
):
    """Lance–Williams on the distances' device; only the (n-1, 4) linkage
    rows visit the host, for the dendrogram cut. Merge order matches
    ``"ward"`` on distinct distances; heights agree to f32 tolerance."""
    del seed  # deterministic
    link = ward_linkage_device(distance_fn(G, measure))
    return cut_tree(link, int(G.shape[0]), m, token_mass, capacity)


def _capacity_groups(
    labels: np.ndarray, token_mass: np.ndarray, m: int, capacity: int
) -> list[np.ndarray]:
    """Repair raw cluster labels into Algorithm-2-feasible groups.

    Over-cap clusters are split first-fit in client-index order (each piece
    <= capacity); then the largest groups split in half until K >= m. Same
    feasibility contract as :func:`repro_torch.core.clustering.tree.cut_tree`:
    every singleton fits (mass <= capacity) or we raise.
    """
    token_mass = np.asarray(token_mass, dtype=np.int64)
    if (token_mass > capacity).any():
        i = int(np.argmax(token_mass > capacity))
        raise ValueError(
            f"client {i} has mass {token_mass[i]} > M={capacity}; allocate its "
            "dedicated distributions first (Section 5 final remark)"
        )
    groups: list[np.ndarray] = []
    for c in np.unique(labels):
        members = np.flatnonzero(labels == c)
        run: list[int] = []
        run_mass = 0
        for i in members:
            if run and run_mass + int(token_mass[i]) > capacity:
                groups.append(np.asarray(run, dtype=np.int64))
                run, run_mass = [], 0
            run.append(int(i))
            run_mass += int(token_mass[i])
        if run:
            groups.append(np.asarray(run, dtype=np.int64))
    n = int(labels.shape[0])
    while len(groups) < m:
        gi = max(range(len(groups)), key=lambda g: len(groups[g]))
        g = groups[gi]
        if len(g) < 2:
            raise ValueError(f"cannot reach K >= m={m} groups with n={n} clients")
        half = len(g) // 2
        groups[gi] = g[:half]
        groups.append(g[half:])
    return groups


def kmeans_clusters(
    G,
    token_mass: np.ndarray,
    m: int,
    capacity: int,
    *,
    measure: str = "arccos",
    distance_fn=None,
    seed: int = 0,
):
    """Lloyd k-means on G's device + capacity repair — the O(n·k·d) backend.

    Never forms an (n, n) matrix (``distance_fn`` is ignored). ``seed``
    fixes the centroid initialisation; the partition is deterministic in
    (G, m, measure, seed).
    """
    del distance_fn  # clusters G directly
    n = int(G.shape[0])
    labels = kmeans_labels(G, min(m, n), measure=measure, seed=seed)
    return _capacity_groups(labels, token_mass, m, capacity)


#: name -> clusterer; ``"ward"`` is the default.
CLUSTERERS = Registry(
    "clusterer",
    {
        "ward": ward_clusters,
        "ward_jit": ward_jit_clusters,
        "kmeans": kmeans_clusters,
    },
)

register_clusterer = CLUSTERERS.register


def resolve_clusterer(clusterer):
    """Name or callable -> callable (names resolve through the registry)."""
    if callable(clusterer):
        return clusterer
    return CLUSTERERS.get(clusterer)
