"""Shared base for gradient-store-backed, plan-rebuilding samplers.

Port of ``src/repro/core/samplers/store_backed.py``. Updates scatter into a
device-resident :class:`repro_torch.fl.gradient_store.GradientStore`, a
:class:`repro_torch.fl.planner.PlanService` rebuilds the plan
(synchronously or on a background worker, on a fixed cadence or a measured
drift trigger), and the freshest completed plan is swapped in at each round
boundary. The scheme zoo (``stratified`` / ``importance`` /
``dp_stratified`` / ``hybrid`` in :mod:`repro_torch.core.samplers.schemes`)
is one ``_build_plan`` override away.

Subclass contract:

* implement :meth:`_build_plan(G) <StoreBackedSampler._build_plan>` — map a
  (device-resident, possibly sketched) gradient block to a
  :class:`~repro_torch.core.types.SamplingPlan`;
* optionally override :meth:`_observe_snapshot` — the value handed to the
  plan service each observed round (``dp_stratified`` clips + noises here);
* optionally set ``validate_plans = False`` for schemes whose plans
  deliberately violate eq. (8) (``importance`` restores unbiasedness by
  re-weighting at draw time instead).

The store's sketch stage (``sketch`` / ``sketch_dim``) is seeded with the
sampler's ``seed``, as in the reference. Not ported yet: the sharded store
(ROADMAP A13) and checkpointing of the store (A10).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.samplers.clustered import ClusteredSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


class StoreBackedSampler(ClusteredSampler):
    """Gradient-store + plan-service machinery shared by rebuild schemes."""

    consumes_updates = True

    #: whether plans are held to the exact Proposition-1 conditions on every
    #: swap; ``importance`` opts out (its rows are the proposal ``q``, not an
    #: eq.(8) allocation) and re-weights draws instead
    validate_plans: bool = True

    def __init__(
        self,
        population: ClientPopulation,
        m: int,
        update_dim: int,
        *,
        seed: int = 0,
        staleness_decay: float = 1.0,
        planner: str = "sync",
        rebuild_every: int = 1,
        drift_threshold: Optional[float] = None,
        sketch: Optional[str] = None,
        sketch_dim: Optional[int] = None,
        device="cuda",
    ):
        """See :class:`~repro_torch.core.samplers.algorithm2.Algorithm2Sampler`
        for the knob semantics."""
        from repro_torch.fl.gradient_store import GradientStore
        from repro_torch.fl.planner import PlanService

        self.update_dim = int(update_dim)
        self.staleness_decay = float(staleness_decay)
        # _build_plan runs for the cold-start plan inside PlanService's
        # constructor, before ClusteredSampler.__init__ sets these (and
        # before any tracker could be attached — set that first too)
        self.population = population
        self.m = int(m)
        self._avail_tracker = None
        self._store = GradientStore(
            population.n_clients,
            update_dim,
            staleness_decay=staleness_decay,
            sketch=sketch,
            sketch_dim=sketch_dim,
            sketch_seed=seed,
            device=device,
        )
        self._service = PlanService(
            self._build_plan,
            mode=planner,
            initial_input=self._store.snapshot(),
            rebuild_every=rebuild_every,
            drift_threshold=drift_threshold,
        )
        super().__init__(
            population,
            self._service.current().plan,
            seed=seed,
            validate=self.validate_plans,
        )

    # -- subclass hooks ------------------------------------------------------
    def _build_plan(self, G) -> SamplingPlan:
        """Map the gradient block (n, d') to this scheme's sampling plan."""
        raise NotImplementedError

    # -- availability-aware planning -----------------------------------------
    def attach_availability(self, tracker) -> None:
        """Restrict plan rebuilds to the tracker's recently-seen clients.

        ``tracker`` is a :class:`~repro_torch.fl.availability.AvailabilityTracker`
        (owned and updated by the server). Schemes that honour it (via
        :meth:`_cluster_mask`) cluster only clients with presence score ≥
        the tracker threshold — FedSTaS-style restratification on the
        observed population — while the plan keeps every client's exact
        eq. (8) mass, so conditional draws stay exactly unbiased over
        whichever clients are available. The mask also rides every plan
        observation, giving the drift monitor its churn term.
        """
        self._avail_tracker = tracker

    def _cluster_mask(self):
        """The rebuild's active-client mask, or None for a full-fleet build.

        None when no tracker is attached or when the mask is degenerate
        (all active — the restriction is a no-op; none active — there would
        be nobody to cluster, so the rebuild falls back to the full fleet).
        Reads the tracker's score tensor by reference — safe against the
        async worker because the tracker replaces it, never mutates it.
        """
        if self._avail_tracker is None:
            return None
        mask = self._avail_tracker.active_mask()
        if mask.all() or not mask.any():
            return None
        return mask

    def _observe_snapshot(self):
        """The value handed to the plan service per observed round.

        Default: a snapshot of the store's tensor. ``dp_stratified``
        overrides this with a clipped + noised copy, back on the store's
        device (and spends privacy budget).
        """
        return self._store.snapshot()

    # -- plan lifecycle ------------------------------------------------------
    def _swap_freshest(self) -> None:
        vp = self._service.poll()
        if vp is not None:
            self.set_plan(vp.plan, validate=self.validate_plans)

    def observe_updates(self, client_ids, updates) -> None:
        """Scatter the round's updates into the store and trigger a rebuild.

        ``updates`` may be the engine's device tensor; it is scattered on the
        device and the plan service receives :meth:`_observe_snapshot` (a
        snapshot of G by default).
        """
        if tuple(updates.shape) != (len(client_ids), self.update_dim):
            raise ValueError(
                f"updates shape {tuple(updates.shape)} != ({len(client_ids)}, {self.update_dim})"
            )
        self._store.update(client_ids, updates)
        self._service.observe(self._observe_snapshot(), active=self._cluster_mask())
        if self._service.mode == "sync":
            self._swap_freshest()

    def plan_telemetry(self) -> tuple[int, int]:
        return self._service.telemetry()

    def plan_cost_telemetry(self) -> tuple[float, float]:
        return self._service.last_build_ms(), self._service.last_drift()

    def flush_plan(self) -> None:
        """Block until any in-flight rebuild lands, then swap it in."""
        self._service.flush()
        self._swap_freshest()

    def close(self) -> None:
        self._service.close()

    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        del round_idx
        self._swap_freshest()  # round boundary: adopt the freshest plan
        return self._draw_from_plan(self._plan, available)
