# Copied from src/repro/core/samplers/uniform.py.
"""FedAvg sampling (McMahan et al., 2017) — uniform without replacement.

Kept as the biased baseline the paper compares against: the non-sampled
clients' contribution is replaced by the current global model (eq. 3), so
``E[θ^{t+1}] != Σ p_i θ_i^{t+1}`` in general.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.samplers.base import ClientSampler
from repro_torch.core.types import SampleResult


class UniformSampler(ClientSampler):
    unbiased = False

    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        del round_idx
        n = self.population.n_clients
        if available is None:
            pool = np.arange(n)
        else:
            pool = np.flatnonzero(np.asarray(available, dtype=bool))
            if pool.size == 0:
                # nothing to draw from; the server raises EmptyRoundError
                return SampleResult(
                    clients=np.empty(0, np.int64),
                    agg_weights=np.zeros(n),
                    stale_weight=1.0,
                )
        clients = pool[self._rng.choice(pool.size, size=min(self.m, pool.size), replace=False)]
        p = self.population.importances
        weights = np.zeros(n)
        weights[clients] = p[clients]  # n_i/M on sampled clients (eq. 3)
        stale = float(1.0 - weights.sum())  # mass left on the stale global model
        return SampleResult(
            clients=np.sort(clients), agg_weights=weights, stale_weight=stale
        )
