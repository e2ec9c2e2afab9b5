"""Device-side clustering primitives for the plan-rebuild pipeline.

Port of ``src/repro/core/clustering/device.py``, in torch ops on the
input's device (the reference's are jitted JAX, not Pallas):

* :func:`ward_linkage_device` — the Lance–Williams recurrence of
  :mod:`repro_torch.core.clustering.ward` in f32 over the distance matrix
  where it lies. Merge indices stay 0-dim tensors, so the loop never waits
  for the device; only the (n-1, 4) linkage rows come back to the host.
  Merge order equals the numpy reference's whenever pairwise distances are
  distinct (both take the first minimum in row-major order); heights
  agree to f32 tolerance.
* :func:`kmeans_labels` — Lloyd iterations from a host-seeded
  initialisation; O(n·k·d), never an (n, n) matrix.
* :func:`cluster_centroids` / :func:`nearest_centroid_labels` — the
  assignment statistic behind the planner's drift trigger.

G stays where it is (a device tensor, or a numpy array on the host); only
linkage rows and labels return to the host.
"""
from __future__ import annotations

import numpy as np
import torch


def ward_linkage_device(dist) -> np.ndarray:
    """(n, n) distance matrix -> scipy-style (n-1, 4) linkage, on its device."""
    D = torch.as_tensor(dist)
    n = int(D.shape[0])
    if D.dim() != 2 or tuple(D.shape) != (n, n):
        raise ValueError(f"need square distance matrix, got {tuple(D.shape)}")
    if n < 2:
        return np.zeros((0, 4))
    dev = D.device
    ar = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    d2 = torch.where(ar[:, None] == ar[None, :], inf, D.to(torch.float32) ** 2)
    size = torch.ones(n, dtype=torch.float32, device=dev)
    cid = ar.clone()
    active = torch.ones(n, dtype=torch.bool, device=dev)
    out = torch.zeros((n - 1, 4), dtype=torch.float32, device=dev)
    for t in range(n - 1):
        masked = torch.where(active[:, None] & active[None, :], d2, inf)
        # flat first minimum in row-major order: numpy's argmin tie-breaking
        flat = torch.argmin(masked)
        i0, j0 = flat // n, flat % n
        i, j = torch.minimum(i0, j0), torch.maximum(i0, j0)
        dij2 = torch.take(masked, flat)
        ci, cj = torch.take(cid, i), torch.take(cid, j)
        ni, nj = torch.take(size, i), torch.take(size, j)
        out[t] = torch.stack([
            torch.minimum(ci, cj).to(torch.float32),
            torch.maximum(ci, cj).to(torch.float32),
            torch.sqrt(torch.clamp(dij2, min=0.0)),
            ni + nj,
        ])
        # Lance–Williams Ward update: merge j into i over the other active rows
        upd = active & (ar != i) & (ar != j)
        d2_i = d2.index_select(0, i.view(1))[0]
        d2_j = d2.index_select(0, j.view(1))[0]
        new = ((ni + size) * d2_i + (nj + size) * d2_j - size * dij2) / (ni + nj + size)
        row = torch.where(upd, new, d2_i)
        d2.index_copy_(0, i.view(1), row[None, :])
        d2.index_copy_(1, i.view(1), row[:, None])
        size = torch.where(ar == i, ni + nj, size)
        active = active & (ar != j)
        cid = torch.where(ar == i, n + t, cid)
    return out.cpu().numpy().astype(np.float64)


def _row_sumsq(X: torch.Tensor) -> torch.Tensor:
    """Σ_k X_ik² summed by a pairwise tree of elementwise adds.

    A library reduction sums in an order of its own on each device; the
    tree gives the same bits on the CPU and the card. Under arccos a zero
    row is equidistant (|c|² = 1) from every unit-norm initial centroid, so
    its label is decided by the rounding of these norms.
    """
    s = X * X
    while s.shape[1] > 1:
        if s.shape[1] % 2:
            s = torch.cat([s, torch.zeros_like(s[:, :1])], dim=1)
        half = s.shape[1] // 2
        s = s[:, :half] + s[:, half:]
    return s[:, 0]


def _normalize_rows(X: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm; zero rows stay zero."""
    norms = torch.sqrt(_row_sumsq(X))
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    return X / safe[:, None]


def _assign(X: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by squared L2 (first minimum)."""
    d2 = _row_sumsq(X)[:, None] + _row_sumsq(cent)[None, :] - 2.0 * X @ cent.T
    return torch.argmin(d2, dim=1)


def kmeans_labels(
    G,
    k: int,
    *,
    measure: str = "arccos",
    seed: int = 0,
    n_iters: int = 25,
) -> np.ndarray:
    """Deterministic Lloyd k-means over representative gradients.

    Initial centroids are the ``k`` rows of a host
    ``np.random.default_rng(seed)`` permutation, then ``n_iters`` Lloyd
    iterations run on G's device; an empty cluster keeps its centroid. For
    ``measure="arccos"`` rows are L2-normalised first (zero cold-start rows
    stay zero and so share a cluster); ``l2`` / ``l1`` cluster the raw rows.
    """
    n = int(G.shape[0])
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k} for n={n} rows")
    init_idx = np.random.default_rng(seed).permutation(n)[:k]
    X = torch.as_tensor(G).to(torch.float32)
    if measure == "arccos":
        X = _normalize_rows(X)
    cent = X[torch.as_tensor(init_idx, device=X.device)]
    clusters = torch.arange(k, device=X.device)
    for _ in range(int(n_iters)):
        lab = _assign(X, cent)
        onehot = (lab[:, None] == clusters[None, :]).to(torch.float32)
        counts = onehot.sum(dim=0)
        sums = onehot.T @ X
        cent = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return _assign(X, cent).cpu().numpy().astype(np.int64)


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
    return _assign(X, C).cpu().numpy().astype(np.int64)
