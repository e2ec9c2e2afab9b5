"""Device-side assignment primitives behind the planner's drift trigger.

Port of ``cluster_centroids`` and ``nearest_centroid_labels`` from
``src/repro/core/clustering/device.py``; ``ward_linkage_device`` and
``kmeans_labels`` come with a later slice. G stays where it is (a device
tensor, or a numpy array on the host); only labels return to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def cluster_centroids(G, labels: np.ndarray, n_clusters: int) -> torch.Tensor:
    """(k, d) per-cluster mean of G rows; rows with label < 0 are ignored.

    One one-hot matmul on G's device; empty clusters get a zero centroid.
    """
    X = torch.as_tensor(G).to(torch.float32)
    lab = torch.as_tensor(np.asarray(labels), device=X.device)
    k = torch.arange(n_clusters, device=X.device)
    onehot = ((lab[:, None] == k[None, :]) & (lab >= 0)[:, None]).to(torch.float32)
    counts = onehot.sum(dim=0)
    return (onehot.T @ X) / torch.clamp(counts, min=1.0)[:, None]


def nearest_centroid_labels(G, centroids) -> np.ndarray:
    """Assign every G row to its nearest centroid (squared-L2, first-min)."""
    X = torch.as_tensor(G).to(torch.float32)
    C = torch.as_tensor(centroids).to(device=X.device, dtype=torch.float32)
    d2 = (X * X).sum(dim=1)[:, None] + (C * C).sum(dim=1)[None, :] - 2.0 * X @ C.T
    return torch.argmin(d2, dim=1).cpu().numpy().astype(np.int64)
