# Copied from src/repro/core/allocation.py.
"""Urn-filling sample allocation shared by Algorithms 1 and 2.

Both algorithms reduce to the same integer partitioning problem
(Appendix C of the paper): give every client ``m * n_i`` *sample tokens*
(``m*M`` tokens total) and distribute them over ``m`` urns of capacity ``M``
each; urn ``k`` becomes distribution ``W_k`` with
``r_{k,i} = (tokens of client i in urn k) / M``.

* Algorithm 1 seeds nothing and streams clients in descending-mass order.
* Algorithm 2 seeds the ``m`` largest clusters into the urns, then streams
  the remaining clusters' clients into the free space.

Sequential filling guarantees each client occupies a *contiguous* run of
urns, hence appears in at most ``floor(m p_i) + 2`` distributions.

Functions here take an explicit per-client ``token_mass`` instead of
``n_samples`` so Algorithm 2's large-client extension (Section 5 final
remark: clients with ``p_i >= 1/m`` get dedicated probability-1 urns and
only their remainder mass joins the pool) can reuse the same machinery.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def fill_urns_sequential(
    token_stream: Iterable[tuple[int, int]],
    n_clients: int,
    n_urns: int,
    capacity: int,
    *,
    initial: np.ndarray | None = None,
) -> np.ndarray:
    """Pour ``(client, tokens)`` items into ``n_urns`` urns of ``capacity``.

    Urns are filled in index order; a client whose tokens do not fit in the
    current urn spills into the next one(s). Returns the integer allocation
    matrix ``r_tokens`` of shape (n_urns, n_clients).

    ``initial`` (optional) pre-seeds the urns (Algorithm 2's cluster
    seeding); filling then tops urns up to ``capacity`` in index order.
    """
    if initial is not None:
        r_tokens = np.array(initial, dtype=np.int64, copy=True)
        if r_tokens.shape != (n_urns, n_clients):
            raise ValueError(f"initial must be {(n_urns, n_clients)}, got {r_tokens.shape}")
    else:
        r_tokens = np.zeros((n_urns, n_clients), dtype=np.int64)

    fill = r_tokens.sum(axis=1)
    if (fill > capacity).any():
        k = int(np.argmax(fill > capacity))
        raise ValueError(f"urn {k} pre-seeded beyond capacity: {fill[k]} > {capacity}")

    k = 0
    for client, tokens in token_stream:
        if tokens < 0:
            raise ValueError(f"negative token count for client {client}")
        remaining = int(tokens)
        while remaining > 0:
            while k < n_urns and fill[k] >= capacity:
                k += 1
            if k >= n_urns:
                raise ValueError(
                    "ran out of urns — token stream exceeds n_urns * capacity "
                    "(Proposition 1 requires sum_i m*n_i == m*M)"
                )
            put = min(remaining, capacity - int(fill[k]))
            r_tokens[k, client] += put
            fill[k] += put
            remaining -= put
    return r_tokens


def allocate_by_size(token_mass: np.ndarray, n_urns: int, capacity: int) -> np.ndarray:
    """Algorithm 1's allocation: descending-mass sequential urn filling.

    Returns the (n_urns, n) integer token matrix; divide by ``capacity``
    (= M) for the probability matrix ``r``.
    """
    token_mass = np.asarray(token_mass, dtype=np.int64)
    if int(token_mass.sum()) != n_urns * capacity:
        raise ValueError(
            f"token mass {token_mass.sum()} != n_urns*capacity = {n_urns * capacity}"
        )
    order = np.argsort(-token_mass, kind="stable")  # descending importance
    stream = ((int(i), int(token_mass[i])) for i in order)
    return fill_urns_sequential(stream, token_mass.shape[0], n_urns, capacity)


def allocate_by_groups(
    token_mass: np.ndarray,
    n_urns: int,
    capacity: int,
    groups: Sequence[np.ndarray],
) -> np.ndarray:
    """Algorithm 2's allocation: cluster-seeded sequential urn filling.

    ``groups`` is the tree cut — K >= n_urns disjoint client-index arrays
    whose mass ``q_k = sum_{i in B_k} token_mass[i]`` must each be
    <= capacity. The n_urns largest groups seed the urns; remaining groups'
    clients stream into the free space in group order (Fig. 4 of the paper).
    """
    token_mass = np.asarray(token_mass, dtype=np.int64)
    n = token_mass.shape[0]
    if int(token_mass.sum()) != n_urns * capacity:
        raise ValueError(
            f"token mass {token_mass.sum()} != n_urns*capacity = {n_urns * capacity}"
        )
    K = len(groups)
    if K < n_urns:
        raise ValueError(f"need K >= m groups, got K={K} < m={n_urns}")

    q = np.array([int(token_mass[np.asarray(g, dtype=np.int64)].sum()) for g in groups])
    if (q > capacity).any():
        k = int(np.argmax(q > capacity))
        raise ValueError(f"group {k} carries {q[k]} tokens > M={capacity}; re-cut the tree")

    order = np.argsort(-q, kind="stable")  # decreasing q_k
    seeded, rest = order[:n_urns], order[n_urns:]

    initial = np.zeros((n_urns, n), dtype=np.int64)
    for k, g_idx in enumerate(seeded):
        for i in np.asarray(groups[g_idx], dtype=np.int64):
            initial[k, i] = int(token_mass[i])

    stream = (
        (int(i), int(token_mass[i]))
        for g_idx in rest
        for i in np.asarray(groups[g_idx], dtype=np.int64)
    )
    return fill_urns_sequential(stream, n, n_urns, capacity, initial=initial)
