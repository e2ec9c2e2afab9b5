# Copied from src/repro/core/clustering/similarity.py.
"""Client-similarity measures over representative gradients (Section 5).

The representative gradient of client i is ``G_i = θ_i^{t+1} - θ^t`` — the
difference between its locally-updated model and the global model it started
from (Sattler et al., 2019). The paper evaluates three measures: Arccos
(angle), L2 and L1, and finds them equivalent in practice (Appendix D.2).

The O(n²d) pairwise computation is the one device-side hot-spot of
Algorithm 2 — ``repro_torch.kernels.similarity`` provides the CUDA kernel
that the sampler runs; this module holds the f64 numpy definitions of the
measures, which the tests use as an oracle.
"""
from __future__ import annotations

import numpy as np

MEASURES = ("arccos", "l2", "l1")


def pairwise_distances(G: np.ndarray, measure: str = "arccos") -> np.ndarray:
    """(n, d) stacked representative gradients -> (n, n) distance matrix.

    * ``arccos``: angle between vectors, in [0, π]. Zero vectors (clients
      never sampled yet — the paper assigns them a constant 0 representative
      gradient so they cluster together) are mutually at distance 0 and at
      π/2 from everything else.
    * ``l2`` / ``l1``: Minkowski distances.
    """
    G = np.asarray(G, dtype=np.float64)
    n = G.shape[0]
    if measure == "arccos":
        norms = np.linalg.norm(G, axis=1)
        safe = np.where(norms > 0, norms, 1.0)
        cos = (G @ G.T) / np.outer(safe, safe)
        zero = norms == 0
        # zero-vs-zero -> cos 1 (distance 0); zero-vs-nonzero -> cos 0 (π/2)
        cos[zero[:, None] & zero[None, :]] = 1.0
        cos[zero[:, None] ^ zero[None, :]] = 0.0
        cos = np.clip(cos, -1.0, 1.0)
        dist = np.arccos(cos)
    elif measure == "l2":
        sq = (G**2).sum(axis=1)
        dist = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * (G @ G.T), 0.0))
    elif measure == "l1":
        dist = np.abs(G[:, None, :] - G[None, :, :]).sum(axis=-1)
    else:
        raise ValueError(f"unknown measure {measure!r}; choose from {MEASURES}")
    np.fill_diagonal(dist, 0.0)
    return np.maximum(dist, dist.T)  # enforce exact symmetry
