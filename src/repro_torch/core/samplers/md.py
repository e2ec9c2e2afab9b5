# Copied from src/repro/core/samplers/md.py.
"""MD sampling (Li et al., 2018) — the paper's reference scheme.

``m`` iid draws from the multinomial W_0 with P(i) = p_i; aggregation
weight 1/m per draw (eq. 4). Special case of clustered sampling with
``W_k = W_0`` for every k.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.samplers.base import ClientSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


class MDSampler(ClientSampler):
    unbiased = True

    def __init__(self, population: ClientPopulation, m: int, *, seed: int = 0):
        super().__init__(population, m, seed=seed)
        p = population.importances
        self._plan = SamplingPlan(r=np.tile(p, (m, 1)))

    @property
    def plan(self) -> SamplingPlan:
        return self._plan

    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        del round_idx
        # under an availability mask every row conditions to p·a / Σ p_j a_j
        # — MD sampling restricted to the available set, still unbiased there
        return self._draw_from_plan(self._plan, available)
