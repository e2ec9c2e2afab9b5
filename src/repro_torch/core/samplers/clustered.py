# Copied from src/repro/core/samplers/clustered.py.
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

    # -- checkpointable state ------------------------------------------------
    # The plan matrices ride in the checkpoint so a restored sampler draws
    # from the *exact* plan that was live at kill time (Algorithm 2's plan
    # is data-dependent; re-deriving it from a restored gradient store would
    # tie resume correctness to distance-backend determinism).
    def state_arrays(self) -> dict:
        arrays = {"plan_r": np.asarray(self._plan.r)}
        if self._plan.r_tokens is not None:
            arrays["plan_r_tokens"] = np.asarray(self._plan.r_tokens)
        if self._plan.cluster_of is not None:
            arrays["plan_cluster_of"] = np.asarray(self._plan.cluster_of)
        return arrays

    def load_state(self, meta: dict, arrays: dict) -> None:
        super().load_state(meta, {})
        plan = SamplingPlan(
            r=np.asarray(arrays["plan_r"], np.float64),
            r_tokens=(
                np.asarray(arrays["plan_r_tokens"], np.int64)
                if "plan_r_tokens" in arrays
                else None
            ),
            cluster_of=(
                np.asarray(arrays["plan_cluster_of"], np.int64)
                if "plan_cluster_of" in arrays
                else None
            ),
        )
        # restored state is trusted (it was validated when first set)
        self.set_plan(plan, validate=False)
