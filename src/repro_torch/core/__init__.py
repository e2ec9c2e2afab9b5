# Copied from src/repro/core/__init__.py.
"""Clustered client sampling for federated learning (Fraboni et al., ICML'21),
the port's host-side (numpy) client-selection core.

Public API:
  - ClientPopulation / SamplingPlan / SampleResult datatypes
  - samplers: UniformSampler (FedAvg), MDSampler, Algorithm1Sampler,
    Algorithm2Sampler, TargetSampler, generic ClusteredSampler, and the
    scheme zoo (StratifiedSampler, ImportanceSampler, DPStratifiedSampler,
    HybridSampler) on the shared StoreBackedSampler contract
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
    DPStratifiedSampler,
    HybridSampler,
    ImportanceSampler,
    MDSampler,
    StoreBackedSampler,
    StratifiedSampler,
    TargetSampler,
    UniformSampler,
    build_plan_algorithm1,
    build_plan_algorithm2,
    build_plan_hybrid,
    build_plan_stratified,
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
    "StratifiedSampler",
    "ImportanceSampler",
    "DPStratifiedSampler",
    "HybridSampler",
    "build_plan_algorithm1",
    "build_plan_algorithm2",
    "build_plan_target",
    "build_plan_stratified",
    "build_plan_hybrid",
    "validate_plan",
    "max_draws_bound",
    "statistics",
    "Registry",
    "SAMPLERS",
    "register_sampler",
]
