# Adapted from src/repro/core/__init__.py, without the scheme zoo (ROADMAP A9).
"""Host-side (numpy) client-selection core, mirroring ``repro.core``.

Public API:
  - ClientPopulation / SamplingPlan / SampleResult datatypes
  - samplers: UniformSampler (FedAvg), MDSampler, Algorithm1Sampler,
    Algorithm2Sampler, TargetSampler and the generic ClusteredSampler
  - validate_plan: exact Proposition-1 checking
  - statistics: closed-form variance / inclusion-probability formulas
"""
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult
from repro_torch.core.registry import Registry
from repro_torch.core.samplers import (
    SAMPLERS,
    register_sampler,
    Algorithm1Sampler,
    Algorithm2Sampler,
    ClientSampler,
    ClusteredSampler,
    MDSampler,
    StoreBackedSampler,
    TargetSampler,
    UniformSampler,
    build_plan_algorithm1,
    build_plan_algorithm2,
    build_plan_target,
    max_draws_bound,
    validate_plan,
)
from repro_torch.core import statistics

__all__ = [
    "ClientPopulation",
    "SamplingPlan",
    "SampleResult",
    "ClientSampler",
    "UniformSampler",
    "MDSampler",
    "ClusteredSampler",
    "StoreBackedSampler",
    "Algorithm1Sampler",
    "Algorithm2Sampler",
    "TargetSampler",
    "build_plan_algorithm1",
    "build_plan_algorithm2",
    "build_plan_target",
    "validate_plan",
    "max_draws_bound",
    "statistics",
    "Registry",
    "SAMPLERS",
    "register_sampler",
]
