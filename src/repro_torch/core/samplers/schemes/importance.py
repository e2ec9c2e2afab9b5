# Adapted from src/repro/core/samplers/schemes/importance.py: norms on the
# store's device in torch.
"""Importance sampling of clients: norm-proportional selection, unbiased
re-weighting.

Clients whose recent updates move the global model most (largest
representative-gradient norm) are selected more often; unbiasedness is
restored *exactly* by importance-weighting each draw. With selection
probabilities ``q`` and data ratios ``p``, a draw of client ``i`` carries
aggregation weight ``(1/m)·(p_i/q_i)`` instead of ``1/m``, so::

    E[ω_i] = m · q_i · (1/m)·(p_i/q_i) = p_i          (eq. 12, exact)

and under an availability mask ``a`` the conditional draw (client ``i``
w.p. ``q_i·a_i / Σ_j q_j·a_j`` per urn) is corrected by
``(p_i/q_i)·(Σ_j q_j a_j / Σ_j p_j a_j)``, giving exactly the same
conditional target as every eq.(8) scheme::

    E[ω_i | a] = p_i·a_i / Σ_j p_j·a_j

The plan's rows are the proposal ``q`` (all ``m`` urns identical), which
deliberately violates eq. (8) — columns sum to ``m·q_i``, not ``m·p_i`` —
so this scheme sets ``validate_plans = False`` and owns its unbiasedness at
draw time. Realized weights sum to ``(1/m)·Σ_k p_{l_k}/q_{l_k}`` (≈ 1, = 1
in expectation); the server consumes ``agg_weights`` directly, so the
estimator is the standard self-normalizing-free importance estimator.

``mix`` floors the proposal: ``q = (1−mix)·s/Σs + mix·p`` with
``s_i = p_i·‖G_i‖``, guaranteeing ``q_i > 0`` wherever ``p_i > 0`` (a
zero-probability client with data would make the estimator biased) and
bounding the weight ratio ``p_i/q_i ≤ 1/mix``. ``mix = 1.0`` is *exactly*
MD sampling — bit-identical draws and weights for the same seed — which is
the tier-1 parity gate for this scheme. Cold start (all-zero store) also
degenerates to MD.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.samplers.store_backed import StoreBackedSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


def _row_norms(G) -> np.ndarray:
    """Per-client update norms, taken in f32 on G's device and copied to
    the host in f64 (the reference takes them in f32 with jnp)."""
    return torch.linalg.vector_norm(G, dim=1).cpu().numpy().astype(np.float64)


def importance_probabilities(
    p: np.ndarray, norms: np.ndarray, mix: float
) -> np.ndarray:
    """The proposal ``q``: norm-proportional mass mixed with ``p``.

    ``s_i = p_i·‖G_i‖`` (norm-weighted data mass); ``q = (1−mix)·s/Σs +
    mix·p``. Degenerate norms (all zero — cold start — or non-finite) and
    ``mix >= 1`` return ``p`` *exactly* (same array values, no float drift),
    so the scheme is bit-identical to MD sampling in those regimes.
    """
    p = np.asarray(p, dtype=np.float64)
    s = p * np.asarray(norms, dtype=np.float64)
    tot = float(s.sum())
    if mix >= 1.0 or not np.isfinite(tot) or tot <= 0.0:
        return np.array(p, copy=True)
    return (1.0 - mix) * (s / tot) + mix * p


class ImportanceSampler(StoreBackedSampler):
    """Norm-proportional client selection with exact unbiased re-weighting."""

    scheme_name = "importance"
    validate_plans = False  # rows are the proposal q, not an eq.(8) plan
    # sample() multiplies its own p/q correction into the weights; layering
    # the scheduler's urn-cyclic overselection re-weighting on top would
    # double-correct, so this scheme opts out of scheduler="overselect"
    supports_overselect = False

    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        update_dim: int,
        *,
        mix: float = 0.1,
        seed: int = 0,
        staleness_decay: float = 1.0,
        planner: str = "sync",
        rebuild_every: int = 1,
        sketch: Optional[str] = None,
        sketch_dim: Optional[int] = None,
        store_mesh_spec=None,
        device="cuda",
    ):
        """``mix`` ∈ (0, 1]: proposal floor (weight-ratio bound 1/mix);
        1.0 = exact MD sampling. No ``drift_threshold``/``clusterer`` — the
        plan has no cluster structure for the drift monitor to measure, so
        those PlannerSpec knobs are rejected at build time rather than
        silently degenerating."""
        if not 0.0 < mix <= 1.0:
            raise ValueError(
                f"mix must be in (0, 1], got {mix}; mix = 0 could assign a "
                "data-carrying client selection probability 0, making the "
                "importance estimator biased"
            )
        self.mix = float(mix)
        super().__init__(
            population,
            m,
            update_dim,
            seed=seed,
            staleness_decay=staleness_decay,
            planner=planner,
            rebuild_every=rebuild_every,
            sketch=sketch,
            sketch_dim=sketch_dim,
            store_mesh_spec=store_mesh_spec,
            device=device,
        )

    def _build_plan(self, G) -> SamplingPlan:
        q = importance_probabilities(
            self.population.importances, _row_norms(G), self.mix
        )
        return SamplingPlan(r=np.tile(q, (self.m, 1)))

    def correction(self, available: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-client weight correction ``c_i`` the current plan's draws carry.

        A draw of client ``i`` is re-weighted by ``c_i = (p_i/q_i)·(Σ q_j a_j
        / Σ p_j a_j)`` (the availability ratio is 1 with a full mask), which
        is exactly what makes ``E[ω_i | a] = p_i·a_i / Σ_j p_j·a_j``. Exposed
        for the property tests' closed-form bookkeeping.
        """
        q = self._plan.r[0]
        p = self.population.importances
        c = np.divide(p, q, out=np.zeros_like(p), where=q > 0)
        if available is None:
            return c  # q and p both sum to 1: the ratio of sums is exactly 1
        a = np.asarray(available, dtype=bool)
        pa = float((p * a).sum())
        if pa <= 0.0:
            return np.zeros_like(p)
        return c * (float((q * a).sum()) / pa)

    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        del round_idx
        self._swap_freshest()
        res = self._draw_from_plan(self._plan, available)
        if res.clients.size == 0:  # fully-masked round: nothing to re-weight
            return res
        c = self.correction(available)
        # mix = 1.0 (or cold start): q == p exactly, c == 1.0 elementwise,
        # and the product below is bit-identical to the MD weights
        return SampleResult(
            clients=res.clients,
            agg_weights=res.agg_weights * c,
            stale_weight=res.stale_weight,
        )
