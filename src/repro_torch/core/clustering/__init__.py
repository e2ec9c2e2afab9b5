# Copied from src/repro/core/clustering/__init__.py.
"""Similarity measures, Ward linkage, tree cut and the clusterer registry."""
from repro_torch.core.clustering.similarity import MEASURES, pairwise_distances
from repro_torch.core.clustering.ward import ward_linkage, linkage_children, leaves_of
from repro_torch.core.clustering.tree import cut_tree
from repro_torch.core.clustering.device import (
    cluster_centroids,
    kmeans_labels,
    nearest_centroid_labels,
    ward_linkage_device,
)
from repro_torch.core.clustering.backends import (
    CLUSTERERS,
    kmeans_clusters,
    register_clusterer,
    resolve_clusterer,
    ward_clusters,
    ward_jit_clusters,
)

__all__ = [
    "MEASURES",
    "pairwise_distances",
    "ward_linkage",
    "linkage_children",
    "leaves_of",
    "cut_tree",
    "ward_linkage_device",
    "kmeans_labels",
    "cluster_centroids",
    "nearest_centroid_labels",
    "CLUSTERERS",
    "register_clusterer",
    "resolve_clusterer",
    "ward_clusters",
    "ward_jit_clusters",
    "kmeans_clusters",
]
