"""Algorithm 2's plan and the clustered draw, in NumPy float64.

Frozen copies of the port's host path (the paper's Algorithm 2, Sections
3 and 5): ``core/clustering/ward.py`` (Lance–Williams Ward),
``core/clustering/tree.py`` (the cut into K >= m groups of mass <= M),
``core/allocation.py`` (cluster-seeded urn filling),
``core/samplers/algorithm2.py`` (the plan, without a cluster mask) and
``core/samplers/base.py`` (the inverse-CDF draw, one uniform an urn).
The distances are the arccos of the cosine of the store's rows, worked out
here in float64 (a zero row is at 0 from a zero row and at π/2 from any
other).
"""
from __future__ import annotations

import numpy as np


def arccos_distances(G: np.ndarray) -> np.ndarray:
    G = np.asarray(G, np.float64)
    gram = G @ G.T
    norms = np.sqrt(np.clip(np.diag(gram), 0.0, None))
    safe = np.where(norms > 0, norms, 1.0)
    cos = gram / (safe[:, None] * safe[None, :])
    zero = norms == 0
    cos = np.where(zero[:, None] & zero[None, :], 1.0, cos)
    cos = np.where(zero[:, None] ^ zero[None, :], 0.0, cos)
    dist = np.arccos(np.clip(cos, -1.0, 1.0))
    dist = 0.5 * (dist + dist.T)
    np.fill_diagonal(dist, 0.0)
    return dist


def ward_linkage(dist: np.ndarray) -> np.ndarray:
    d2 = np.asarray(dist, np.float64) ** 2
    n = d2.shape[0]
    size = np.ones(n, dtype=np.int64)
    cid = np.arange(n)
    active = np.ones(n, dtype=bool)
    np.fill_diagonal(d2, np.inf)
    out = np.zeros((n - 1, 4))
    for t in range(n - 1):
        masked = np.where(active[:, None] & active[None, :], d2, np.inf)
        i, j = divmod(int(np.argmin(masked)), n)
        if i > j:
            i, j = j, i
        dij2 = masked[i, j]
        a, b = sorted((cid[i], cid[j]))
        out[t] = (a, b, np.sqrt(max(dij2, 0.0)), size[i] + size[j])
        ni, nj = size[i], size[j]
        upd = active.copy()
        upd[i] = upd[j] = False
        nk = size[upd]
        new = ((ni + nk) * d2[i, upd] + (nj + nk) * d2[j, upd] - nk * dij2) / (ni + nj + nk)
        d2[i, upd] = new
        d2[upd, i] = new
        size[i] = ni + nj
        active[j] = False
        cid[i] = n + t
    return out


def _leaves(c: int, children: dict) -> list:
    stack, out = [c], []
    while stack:
        x = stack.pop()
        if x in children:
            stack.extend(children[x])
        else:
            out.append(x)
    return out


def cut_tree(link: np.ndarray, n: int, m: int, mass: np.ndarray, capacity: int) -> list:
    children = {n + t: (int(link[t, 0]), int(link[t, 1])) for t in range(link.shape[0])}
    height = {n + t: float(link[t, 2]) for t in range(link.shape[0])}
    clusters = [n + link.shape[0] - 1 if link.shape[0] else 0]

    def weight(c):
        return int(mass[_leaves(c, children)].sum())

    while True:
        over = [c for c in clusters if c in children and weight(c) > capacity]
        if over:
            c = over[0]
        elif len(clusters) < m:
            c = max((c for c in clusters if c in children), key=lambda c: height[c])
        else:
            break
        clusters.remove(c)
        clusters.extend(children[c])
    return [np.array(sorted(_leaves(c, children)), dtype=np.int64) for c in clusters]


def allocate_by_groups(mass: np.ndarray, n_urns: int, capacity: int, groups: list) -> np.ndarray:
    n = mass.shape[0]
    q = np.array([int(mass[g].sum()) for g in groups])
    order = np.argsort(-q, kind="stable")
    tokens = np.zeros((n_urns, n), dtype=np.int64)
    for k, g in enumerate(order[:n_urns]):
        tokens[k, groups[g]] = mass[groups[g]]
    fill = tokens.sum(axis=1)
    k = 0
    for g in order[n_urns:]:
        for i in groups[g]:
            left = int(mass[i])
            while left > 0:
                while fill[k] >= capacity:
                    k += 1
                put = min(left, capacity - int(fill[k]))
                tokens[k, i] += put
                fill[k] += put
                left -= put
    return tokens


def algorithm2_plan(G: np.ndarray, n_samples: np.ndarray, m: int) -> np.ndarray:
    """The (m, n) integer token matrix r_tokens of Algorithm 2 over store G."""
    n_samples = np.asarray(n_samples, np.int64)
    M = int(n_samples.sum())
    mass = m * n_samples
    full = mass // M
    pool_mass = mass - full * M
    m_pool = m - int(full.sum())
    n = mass.shape[0]
    tokens = np.zeros((m, n), dtype=np.int64)
    owners = np.repeat(np.arange(n), full)
    tokens[np.arange(owners.size), owners] = M
    if m_pool > 0:
        pool = np.flatnonzero(pool_mass > 0)
        link = ward_linkage(arccos_distances(np.asarray(G)[pool]))
        groups = [pool[g] for g in cut_tree(link, pool.size, m_pool, pool_mass[pool], M)]
        tokens[owners.size:] = allocate_by_groups(pool_mass, m_pool, M, groups)
    return tokens


def md_plan(n_samples: np.ndarray, m: int) -> np.ndarray:
    """MD's plan: every urn the importances p (float64)."""
    p = np.asarray(n_samples, np.int64) / int(np.sum(n_samples))
    return np.tile(p, (m, 1))


def draw(r: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One client an urn: inverse CDF with ties to the right."""
    cdf = np.cumsum(np.asarray(r, np.float64), axis=1)
    cdf /= cdf[:, -1][:, None]
    u = rng.random(r.shape[0])
    return (cdf <= u[:, None]).sum(axis=1).astype(np.int64)
