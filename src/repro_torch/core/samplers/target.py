# Copied from src/repro/core/samplers/target.py.
"""'Target' oracle sampling (Section 6, Fig. 1).

The controlled MNIST experiment's ideal scheme: the true client grouping
(e.g. by owned class) is known, one client is drawn from each group per
round. Only usable in simulation — the server cannot know client data
distributions — but it upper-bounds what Algorithm 2 can converge to.

Implemented as a clustered-sampling plan whose groups are the oracle
clusters, so all Proposition-1 machinery applies when group masses are
balanced (each group must carry exactly M tokens for exact unbiasedness;
otherwise the plan is the best unbiased approximation via urn filling with
oracle groups).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import allocate_by_groups
from repro_torch.core.samplers.clustered import ClusteredSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan


def build_plan_target(
    population: ClientPopulation, m: int, groups: list[np.ndarray]
) -> SamplingPlan:
    M = population.total_samples
    mass = m * population.n_samples
    tokens = allocate_by_groups(mass, m, M, groups)
    cluster_of = np.full(population.n_clients, -1, dtype=np.int64)
    for gid, g in enumerate(groups):
        cluster_of[np.asarray(g, dtype=np.int64)] = gid
    return SamplingPlan(r=tokens / M, r_tokens=tokens, cluster_of=cluster_of)


class TargetSampler(ClusteredSampler):
    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        groups: list[np.ndarray],
        *,
        seed: int = 0,
    ):
        super().__init__(population, build_plan_target(population, m, groups), seed=seed)
