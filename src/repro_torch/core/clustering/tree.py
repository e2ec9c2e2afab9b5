# Copied from src/repro/core/clustering/tree.py.
"""Dendrogram cut producing Algorithm-2-feasible groups.

Algorithm 2 (line 3) needs ``K >= m`` groups whose token mass
``q_k = sum_{i in B_k} m * n_i`` is at most ``M`` each. We cut the Ward tree
top-down: starting from the root, repeatedly split the *worst* cluster —
any cluster over the mass cap, else (until K >= m) the one whose split is
cheapest in linkage distance. Splitting along dendrogram edges keeps
similar clients together, which is the whole point of the similarity-based
scheme.

Feasibility: with every ``m * n_i <= M`` (``p_i <= 1/m``, Theorem 4's
hypothesis) singleton clusters always satisfy the cap, so the loop
terminates.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.clustering.ward import leaves_of, linkage_children


def cut_tree(
    linkage: np.ndarray,
    n: int,
    m: int,
    token_mass: np.ndarray,
    capacity: int,
) -> list[np.ndarray]:
    """Cut a linkage into K >= m groups with per-group mass <= capacity.

    Args:
      linkage: (n-1, 4) scipy-style linkage.
      n: number of leaves (clients).
      m: number of sampling distributions.
      token_mass: per-client mass ``m * n_i`` (shape (n,)).
      capacity: M, the per-urn capacity.

    Returns a list of disjoint client-index arrays covering 0..n-1.
    """
    token_mass = np.asarray(token_mass, dtype=np.int64)
    if (token_mass > capacity).any():
        i = int(np.argmax(token_mass > capacity))
        raise ValueError(
            f"client {i} has mass {token_mass[i]} > M={capacity}; allocate its "
            "dedicated distributions first (Section 5 final remark)"
        )
    children = linkage_children(linkage, n)
    # merge height of every internal node, for cheapest-split ordering
    height = {n + t: float(linkage[t, 2]) for t in range(linkage.shape[0])}

    root = n + linkage.shape[0] - 1 if linkage.shape[0] else 0
    clusters: list[int] = [root]

    def mass(c: int) -> int:
        return int(token_mass[leaves_of(c, children)].sum())

    while True:
        over = [c for c in clusters if c in children and mass(c) > capacity]
        if over:
            c = over[0]
        elif len(clusters) < m:
            splittable = [c for c in clusters if c in children]
            if not splittable:
                raise ValueError(f"cannot reach K >= m={m} groups with n={n} clients")
            # split the node merged last/highest -> least-similar grouping
            c = max(splittable, key=lambda c: height[c])
        else:
            break
        clusters.remove(c)
        clusters.extend(children[c])

    # any cluster left over the cap must be a leaf — impossible per guard above
    groups = [np.array(sorted(leaves_of(c, children)), dtype=np.int64) for c in clusters]
    assert sum(len(g) for g in groups) == n
    return groups
