# Copied from src/repro/core/clustering/ward.py.
"""Ward hierarchical agglomerative clustering (Ward, 1963).

Own implementation (Lance–Williams recurrence) producing a scipy-compatible
linkage matrix, so tests can cross-check against ``scipy.cluster.hierarchy``.
Complexity O(n³) worst case with the masked-matrix scan, but every inner
step is a vectorized numpy update (no per-k Python loop) — the planner runs
Ward on every rebuild, so at n ≈ 10³ this is the difference between
milliseconds and seconds; the O(n²d) part (the distance matrix itself) is
what the CUDA kernel accelerates.
"""
from __future__ import annotations

import numpy as np


def ward_linkage(dist: np.ndarray) -> np.ndarray:
    """(n, n) distance matrix -> (n-1, 4) linkage [id_a, id_b, dist, size].

    Follows scipy convention: original points are clusters 0..n-1; the merge
    at row t creates cluster n+t. Ward's minimum-variance criterion via the
    Lance–Williams update on squared distances.
    """
    dist = np.asarray(dist, dtype=np.float64)
    n = dist.shape[0]
    if dist.shape != (n, n):
        raise ValueError(f"need square distance matrix, got {dist.shape}")
    if n < 2:
        return np.zeros((0, 4))

    d2 = dist.astype(np.float64) ** 2  # work on squared distances
    size = np.ones(n, dtype=np.int64)
    cluster_id = np.arange(n)  # current scipy id of each active slot
    active = np.ones(n, dtype=bool)
    np.fill_diagonal(d2, np.inf)

    out = np.zeros((n - 1, 4))
    for t in range(n - 1):
        # find the closest active pair
        masked = np.where(active[:, None] & active[None, :], d2, np.inf)
        flat = int(np.argmin(masked))
        i, j = divmod(flat, n)
        if i > j:
            i, j = j, i
        dij2 = masked[i, j]
        a, b = cluster_id[i], cluster_id[j]
        if a > b:
            a, b = b, a
        out[t] = (a, b, np.sqrt(max(dij2, 0.0)), size[i] + size[j])

        # Lance–Williams Ward update: merge j into i (masked vector update —
        # same arithmetic as the per-k scalar recurrence, so bit-identical)
        ni, nj = size[i], size[j]
        upd = active.copy()
        upd[i] = upd[j] = False
        nk = size[upd]
        new = ((ni + nk) * d2[i, upd] + (nj + nk) * d2[j, upd] - nk * dij2) / (
            ni + nj + nk
        )
        d2[i, upd] = new
        d2[upd, i] = new
        size[i] = ni + nj
        active[j] = False
        cluster_id[i] = n + t
    return out


def linkage_children(linkage: np.ndarray, n: int) -> dict[int, tuple[int, int]]:
    """Map merged-cluster id -> (child_a, child_b)."""
    return {n + t: (int(linkage[t, 0]), int(linkage[t, 1])) for t in range(linkage.shape[0])}


def leaves_of(cluster: int, children: dict[int, tuple[int, int]]) -> list[int]:
    """Collect original leaf indices under a dendrogram node."""
    stack, leaves = [cluster], []
    while stack:
        c = stack.pop()
        if c in children:
            stack.extend(children[c])
        else:
            leaves.append(c)
    return leaves
