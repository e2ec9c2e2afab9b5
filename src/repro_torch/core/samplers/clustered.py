# Adapted from src/repro/core/samplers/clustered.py, without checkpoint
# state.
"""Generic clustered sampler: m independent draws from an arbitrary plan.

Any ``r`` matrix satisfying Proposition 1 can be plugged in — Algorithms 1
and 2 are factories producing such plans; this class does the actual
per-round drawing (Section 3.1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.samplers.base import ClientSampler, validate_plan
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


class ClusteredSampler(ClientSampler):
    unbiased = True

    def __init__(
        self,
        population: ClientPopulation,
        plan: SamplingPlan,
        *,
        seed: int = 0,
        validate: bool = True,
    ):
        super().__init__(population, plan.m, seed=seed)
        if validate:
            validate_plan(plan, population)
        self._plan = plan

    @property
    def plan(self) -> SamplingPlan:
        return self._plan

    def set_plan(self, plan: SamplingPlan, *, validate: bool = True) -> None:
        if validate:
            validate_plan(plan, self.population)
        if plan.m != self.m:
            raise ValueError(f"plan has m={plan.m}, sampler has m={self.m}")
        self._plan = plan

    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        del round_idx
        return self._draw_from_plan(self._plan, available)
