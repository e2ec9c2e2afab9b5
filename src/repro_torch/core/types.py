# Copied from src/repro/core/types.py.
"""Core datatypes for the clustered-sampling library.

Everything in ``repro_torch.core`` is host-side (numpy) — client selection is an
O(n)–O(n^2) scalar problem the server solves between rounds; only the
similarity matrix over model-sized vectors runs on device (see
``repro_torch.kernels.similarity``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Integer "sample token" arithmetic (Appendix C of the paper): both Algorithm 1
# and 2 are proven in terms of integer sample counts n_i rather than ratios
# p_i, so the allocation is exact with no floating-point drift.


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """The federated population the server samples from.

    Attributes:
      n_samples: integer sample counts ``n_i`` per client, shape (n,).
    """

    n_samples: np.ndarray

    def __post_init__(self):
        arr = np.asarray(self.n_samples, dtype=np.int64)
        if arr.ndim != 1:
            raise ValueError(f"n_samples must be 1-D, got shape {arr.shape}")
        if (arr <= 0).any():
            raise ValueError("every client must own at least one sample")
        object.__setattr__(self, "n_samples", arr)

    @property
    def n_clients(self) -> int:
        return int(self.n_samples.shape[0])

    @property
    def total_samples(self) -> int:
        """M = sum_i n_i."""
        return int(self.n_samples.sum())

    @property
    def importances(self) -> np.ndarray:
        """p_i = n_i / M (eq. 1 of the paper)."""
        return self.n_samples / self.total_samples


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """The ``m`` per-distribution client probabilities ``r_{k,i}``.

    ``r[k, i]`` is the probability that distribution ``W_k`` draws client
    ``i`` (eq. 7/8 of the paper). MD sampling is the special case where every
    row equals ``p``.
    """

    r: np.ndarray  # (m, n) float64
    # Integer sample-token allocation r' with r = r'/M, kept when the plan was
    # built by the urn-filling allocator (exactness checks + debugging).
    r_tokens: Optional[np.ndarray] = None
    # Cluster assignment per client when the plan came from Algorithm 2.
    cluster_of: Optional[np.ndarray] = None

    def __post_init__(self):
        r = np.asarray(self.r, dtype=np.float64)
        if r.ndim != 2:
            raise ValueError(f"r must be (m, n), got {r.shape}")
        object.__setattr__(self, "r", r)

    @property
    def m(self) -> int:
        return int(self.r.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.r.shape[1])


@dataclasses.dataclass(frozen=True)
class SampleResult:
    """One realized round of client selection.

    Attributes:
      clients: the sampled client indices ``l_1..l_m`` (with multiplicity),
        shape (m,).
      agg_weights: aggregation weight ``ω_i`` for every client in the
        population, shape (n,): ``ω_i = (1/m) Σ_k 1{l_k == i}``. Unbiased
        schemes satisfy ``E[ω_i] = p_i`` (eq. 12).
      stale_weights: weight put on the *current global model* for clients that
        are not updated this round. Zero for unbiased schemes; FedAvg-style
        uniform sampling puts ``n_i/M`` of every non-sampled client here
        (eq. 3).
      draw_weights: the per-draw aggregation weight of each entry of
        ``clients``, aligned with it (``agg_weights`` is its client-indexed
        sum). Only populated by draws whose downstream consumer thins at the
        draw level (overselection schedulers); ``None`` for the ordinary
        per-round draw.
    """

    clients: np.ndarray
    agg_weights: np.ndarray
    stale_weight: float = 0.0
    draw_weights: Optional[np.ndarray] = None

    @property
    def unique_clients(self) -> np.ndarray:
        return np.unique(self.clients)
