"""Clustering backends behind the ``CLUSTERERS`` registry.

Port of ``src/repro/core/clustering/backends.py`` with the ``"ward"`` entry
only (``ward_jit`` and ``kmeans`` come with a later slice). A clusterer has
the signature

    clusterer(G, token_mass, m, capacity, *,
              measure="arccos", distance_fn, seed=0) -> list[ndarray]

where ``distance_fn(G, measure)`` returns the (n, n) distances (the port's
similarity op, see ``repro_torch.kernels.similarity.ops``).

and returns disjoint local-index arrays covering ``0..n_pool-1``, each of
token mass <= ``capacity``.
"""
from __future__ import annotations

import numpy as np

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
    dist = np.asarray(distance_fn(G, measure))
    link = ward_linkage(dist)
    return cut_tree(link, int(G.shape[0]), m, token_mass, capacity)


#: name -> clusterer; ``"ward"`` is the default.
CLUSTERERS = Registry("clusterer", {"ward": ward_clusters})

register_clusterer = CLUSTERERS.register


def resolve_clusterer(clusterer):
    """Name or callable -> callable (names resolve through the registry)."""
    if callable(clusterer):
        return clusterer
    return CLUSTERERS.get(clusterer)
