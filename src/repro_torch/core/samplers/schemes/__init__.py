# Copied from src/repro/core/samplers/schemes/__init__.py.
"""The client-selection scheme zoo (beyond the paper's Algorithms 1/2).

Four published competitors to clustered sampling, each implemented on the
shared :class:`~repro_torch.core.samplers.store_backed.StoreBackedSampler`
contract (gradient store → plan service → eq.(7)/(8) ``SamplingPlan``), so
availability conditioning, vectorized draws, plan validation and
population churn compose with zero new code paths:

* ``stratified``    — strata from a clustering objective over the sketched
  gradient store; per-stratum proportional allocation, within-stratum
  draws uniform over sample tokens (Shen et al., stratified client
  selection; FedSTaS-style restratification via the drift trigger).
* ``importance``    — aggregation-norm-proportional selection probabilities
  with exact unbiased re-weighting at draw time (importance sampling of
  clients; Rizk et al. / FedProx-IS lineage).
* ``dp_stratified`` — ``stratified`` with per-round Gaussian noise on the
  stratum statistics and a tracked zCDP → (ε, δ) privacy ledger.
* ``hybrid``        — deterministic head of high-mass clients (their
  ``floor(m·p_i)`` dedicated probability-1 urns) + stratified sampling of
  the tail (the Shen et al. split, sharing Algorithm 2's Section-5 head).

All four are ``SAMPLERS`` registry entries, hence constructible from a JSON
``ExperimentSpec`` and raced head-to-head by
:mod:`repro_torch.benchmarks.scheme_race`.
"""
from repro_torch.core.samplers.schemes.dp import DPStratifiedSampler, gaussian_epsilon
from repro_torch.core.samplers.schemes.hybrid import HybridSampler, build_plan_hybrid
from repro_torch.core.samplers.schemes.importance import (
    ImportanceSampler,
    importance_probabilities,
)
from repro_torch.core.samplers.schemes.stratified import (
    StratifiedSampler,
    build_plan_stratified,
    default_n_strata,
)

__all__ = [
    "StratifiedSampler",
    "ImportanceSampler",
    "DPStratifiedSampler",
    "HybridSampler",
    "build_plan_stratified",
    "build_plan_hybrid",
    "importance_probabilities",
    "default_n_strata",
    "gaussian_epsilon",
]
