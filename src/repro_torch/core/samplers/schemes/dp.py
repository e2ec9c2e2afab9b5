# Adapted from src/repro/core/samplers/schemes/dp.py: the noised release
# goes back to the store's device.
"""Differentially private stratified selection (FedProx-stratified-DP lineage).

The selection statistics a stratified sampler consumes — the per-client
representative gradients that determine stratum membership — leak
information about client data. This scheme releases them through the
Gaussian mechanism each observed round: rows are L2-clipped to
``clip_norm`` (sensitivity C), Gaussian noise ``N(0, (σC)²)`` with
``σ = noise_multiplier`` is added, and only the *noised* statistics reach
the plan service. The resident gradient store itself keeps the exact
updates (it is server-side state, same trust domain as the model updates
the server already aggregates); what is protected is the selection
pipeline's view — strata, drift statistics, and anything derived from the
plan — which becomes a post-processing of the noised release.

Privacy accounting is zero-concentrated DP: each per-round release costs
``ρ_step = 1/(2σ²)``; after ``T`` releases ``ρ = T/(2σ²)`` converts to an
(ε, δ) guarantee via ``ε = ρ + 2·√(ρ·ln(1/δ))``. The ledger (release
count, ρ, ε, δ) is :attr:`DPStratifiedSampler.privacy_ledger` and rides
every checkpoint with the noise generator's state. Accounting is
deliberately conservative: every observed round is counted as a release
even when the rebuild cadence discards it.

Crucially the *plan* stays exactly unbiased: noise only moves clients
between strata; the token allocation is still driven by the true ``n_i``,
so eq. (7)/(8) hold exactly and ``E[ω_i] = p_i`` is untouched by any noise
level. DP costs convergence speed (worse strata), never bias.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.samplers.algorithm2 import DistanceFn
from repro_torch.core.samplers.schemes.stratified import StratifiedSampler
from repro_torch.core.types import ClientPopulation


def gaussian_epsilon(rho: float, delta: float) -> float:
    """(ε, δ) from zCDP: ε = ρ + 2·√(ρ·ln(1/δ)) (Bun & Steinke, Prop. 1.3)."""
    if rho <= 0.0:
        return 0.0
    return float(rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta)))


class DPStratifiedSampler(StratifiedSampler):
    """Stratified selection over Gaussian-noised statistics + (ε, δ) ledger."""

    scheme_name = "dp_stratified"

    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        update_dim: int,
        *,
        noise_multiplier: float = 1.0,
        clip_norm: float = 1.0,
        delta: float = 1e-5,
        n_strata: Optional[int] = None,
        measure: str = "arccos",
        distance_fn: Union[DistanceFn, str, None] = "auto",
        clusterer: Union[Callable, str] = "ward",
        seed: int = 0,
        staleness_decay: float = 1.0,
        planner: str = "sync",
        rebuild_every: int = 1,
        drift_threshold: Optional[float] = None,
        sketch: Optional[str] = None,
        sketch_dim: Optional[int] = None,
        store_mesh_spec=None,
        device="cuda",
    ):
        """``noise_multiplier`` = σ (noise std is σ·clip_norm per coordinate),
        ``clip_norm`` = per-row L2 sensitivity bound C, ``delta`` the ledger's
        conversion target. The DP noise stream draws from its own generator
        (seeded from the sampler seed), so the selection rng and the
        mechanism rng are independent and both checkpoint bit-exactly."""
        if noise_multiplier <= 0.0:
            raise ValueError(f"noise_multiplier must be > 0, got {noise_multiplier}")
        if clip_norm <= 0.0:
            raise ValueError(f"clip_norm must be > 0, got {clip_norm}")
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta must be in (0, 1), got {delta}")
        self.noise_multiplier = float(noise_multiplier)
        self.clip_norm = float(clip_norm)
        self.delta = float(delta)
        self._dp_rng = np.random.default_rng([int(seed), 0xD9])
        self._ledger = {"observations": 0, "rho": 0.0}
        super().__init__(
            population,
            m,
            update_dim,
            n_strata=n_strata,
            measure=measure,
            distance_fn=distance_fn,
            clusterer=clusterer,
            seed=seed,
            staleness_decay=staleness_decay,
            planner=planner,
            rebuild_every=rebuild_every,
            drift_threshold=drift_threshold,
            sketch=sketch,
            sketch_dim=sketch_dim,
            store_mesh_spec=store_mesh_spec,
            device=device,
        )

    @property
    def privacy_ledger(self) -> dict:
        """The tracked budget: releases, zCDP ρ, and the converted (ε, δ)."""
        rho = float(self._ledger["rho"])
        return {
            "observations": int(self._ledger["observations"]),
            "rho": rho,
            "epsilon": gaussian_epsilon(rho, self.delta),
            "delta": self.delta,
        }

    def _observe_snapshot(self):
        """Clip + noise the statistics release; spend one ρ_step.

        One release per observed round (deterministic draw count). The
        cold-start plan built at construction sees the raw all-zeros buffer
        and spends nothing: no client data has entered the store yet. The
        clip and the noise run on the host in f64, as in the reference, so
        the release is bit-equal to it; the f32 result goes back to the
        store's device, where the plan build's distances run.
        """
        G = self._store.snapshot().cpu().numpy().astype(np.float64)
        norms = np.linalg.norm(G, axis=1)
        scale = np.ones_like(norms)
        over = norms > self.clip_norm
        scale[over] = self.clip_norm / norms[over]
        sigma = self.noise_multiplier * self.clip_norm
        noised = G * scale[:, None] + self._dp_rng.normal(0.0, sigma, size=G.shape)
        self._ledger["observations"] += 1
        self._ledger["rho"] += 1.0 / (2.0 * self.noise_multiplier**2)
        return torch.from_numpy(noised.astype(np.float32)).to(self._store.device)

    # -- checkpointable state ------------------------------------------------
    def state_meta(self) -> dict:
        meta = super().state_meta()
        meta["dp_ledger"] = {
            "observations": int(self._ledger["observations"]),
            "rho": float(self._ledger["rho"]),
        }
        meta["dp_rng"] = self._dp_rng.bit_generator.state
        return meta

    def load_state(self, meta: dict, arrays: dict) -> None:
        super().load_state(meta, arrays)
        self._ledger = {
            "observations": int(meta["dp_ledger"]["observations"]),
            "rho": float(meta["dp_ledger"]["rho"]),
        }
        self._dp_rng.bit_generator.state = meta["dp_rng"]
