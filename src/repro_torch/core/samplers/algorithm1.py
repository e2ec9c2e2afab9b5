# Copied from src/repro/core/samplers/algorithm1.py.
"""Algorithm 1 — clustered sampling based on sample size (Section 4).

Deterministic urn-filling over descending-``n_i`` clients. O(n log n); since
it only depends on the ``n_i`` it is computed once and reused every round.
Each client appears in at most ``floor(m p_i) + 2`` distributions, versus
``m`` under MD sampling.
"""
from __future__ import annotations

from repro_torch.core.allocation import allocate_by_size
from repro_torch.core.samplers.clustered import ClusteredSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan


def build_plan_algorithm1(population: ClientPopulation, m: int) -> SamplingPlan:
    M = population.total_samples
    tokens = allocate_by_size(m * population.n_samples, n_urns=m, capacity=M)
    return SamplingPlan(r=tokens / M, r_tokens=tokens)


class Algorithm1Sampler(ClusteredSampler):
    """Sample-size clustered sampling; the plan is static across rounds.

    The plan still runs through the shared
    :class:`repro_torch.fl.planner.PlanService` (always version 0, lag 0 — it
    never observes updates), so plan handoff, telemetry and re-planning
    machinery are uniform across the clustered samplers.
    """

    def __init__(self, population: ClientPopulation, m: int, *, seed: int = 0):
        from repro_torch.fl.planner import PlanService

        self._service = PlanService(lambda _: build_plan_algorithm1(population, m))
        super().__init__(population, self._service.current().plan, seed=seed)

    @property
    def plan_service(self):
        return self._service

    def plan_telemetry(self) -> tuple[int, int]:
        return self._service.telemetry()

    def plan_cost_telemetry(self) -> tuple[float, float]:
        # build cost of the (static) version-0 plan; drift trigger never runs
        return self._service.last_build_ms(), self._service.last_drift()

    def close(self) -> None:
        self._service.close()
