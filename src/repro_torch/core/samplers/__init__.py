# Adapted from src/repro/core/samplers/__init__.py, without the scheme zoo
# (stratified, importance, dp_stratified, hybrid: ROADMAP A9).
"""Client-selection schemes (the paper's core contribution lives here).

``SAMPLERS`` is the registry of schemes: spec-driven construction
(``repro_torch.fl.experiment.SamplerSpec``) resolves names through it, and
``register_sampler("mine", MySampler)`` plugs a new scheme into every
runner and CLI that speaks specs.
"""
from repro_torch.core.registry import Registry
from repro_torch.core.samplers.base import ClientSampler, max_draws_bound, validate_plan
from repro_torch.core.samplers.uniform import UniformSampler
from repro_torch.core.samplers.md import MDSampler
from repro_torch.core.samplers.clustered import ClusteredSampler
from repro_torch.core.samplers.store_backed import StoreBackedSampler
from repro_torch.core.samplers.algorithm1 import Algorithm1Sampler, build_plan_algorithm1
from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler, build_plan_algorithm2
from repro_torch.core.samplers.target import TargetSampler, build_plan_target

SAMPLERS = Registry(
    "sampler",
    {
        "uniform": UniformSampler,
        "md": MDSampler,
        "algorithm1": Algorithm1Sampler,
        "algorithm2": Algorithm2Sampler,
        "target": TargetSampler,
    },
)

register_sampler = SAMPLERS.register

__all__ = [
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
    "Registry",
    "SAMPLERS",
    "register_sampler",
]
