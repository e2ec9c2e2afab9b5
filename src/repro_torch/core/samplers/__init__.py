# Copied from src/repro/core/samplers/__init__.py.
"""Client-selection schemes (the paper's core contribution lives here).

``SAMPLERS`` is the seed *registry* of schemes: spec-driven construction
(``repro_torch.fl.experiment.SamplerSpec``) resolves names through it, and
``register_sampler("mine", MySampler)`` plugs a new scheme into every
runner, benchmark and CLI that speaks specs. Beyond the paper's own
algorithms, :mod:`repro_torch.core.samplers.schemes` contributes the published
competitor zoo — ``stratified`` / ``importance`` / ``dp_stratified`` /
``hybrid`` — all built on the shared
:class:`~repro_torch.core.samplers.store_backed.StoreBackedSampler` contract.
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
from repro_torch.core.samplers.schemes import (
    DPStratifiedSampler,
    HybridSampler,
    ImportanceSampler,
    StratifiedSampler,
    build_plan_hybrid,
    build_plan_stratified,
)

SAMPLERS = Registry(
    "sampler",
    {
        "uniform": UniformSampler,
        "md": MDSampler,
        "algorithm1": Algorithm1Sampler,
        "algorithm2": Algorithm2Sampler,
        "target": TargetSampler,
        "stratified": StratifiedSampler,
        "importance": ImportanceSampler,
        "dp_stratified": DPStratifiedSampler,
        "hybrid": HybridSampler,
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
    "Registry",
    "SAMPLERS",
    "register_sampler",
]
