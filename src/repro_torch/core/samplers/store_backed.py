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
* set :attr:`scheme_name` — rides every checkpoint so a restore into a
  *different* scheme fails loudly instead of silently mixing plan semantics;
* optionally override :meth:`_observe_snapshot` — the value handed to the
  plan service each observed round (``dp_stratified`` clips + noises here);
* optionally set ``validate_plans = False`` for schemes whose plans
  deliberately violate eq. (8) (``importance`` restores unbiasedness by
  re-weighting at draw time instead).

The store's sketch stage (``sketch`` / ``sketch_dim``) is seeded with the
sampler's ``seed``, as in the reference; ``store_mesh_spec`` splits the
store's client axis over a device mesh.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.samplers.clustered import ClusteredSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


class StoreBackedSampler(ClusteredSampler):
    """Gradient-store + plan-service machinery shared by rebuild schemes."""

    consumes_updates = True

    #: checkpoint identity: restoring a bundle written by one scheme into a
    #: sampler of another raises (see :meth:`load_state`)
    scheme_name: str = "store_backed"

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
        store_mesh_spec=None,
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
            mesh_spec=store_mesh_spec,
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

    # -- introspection -------------------------------------------------------
    @property
    def representative_gradients(self) -> np.ndarray:
        """Host copy of the resident G — (n, d'), sketch space if sketched."""
        return self._store.asnumpy()

    @property
    def gradient_store(self):
        return self._store

    @property
    def plan_service(self):
        return self._service

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

    # -- checkpointable state ------------------------------------------------
    def prepare_state(self) -> None:
        """Quiesce the planner so the checkpoint is the sync fixed point.

        With ``planner="async"`` an in-flight rebuild cannot ride in a
        checkpoint; flushing first makes the exported (G, plan, counters)
        bundle self-consistent — a restored server continues exactly as a
        sync-planned one would from this state.
        """
        self.flush_plan()

    def state_arrays(self) -> dict:
        arrays = super().state_arrays()
        arrays["store_G"] = self._store.snapshot()
        return arrays

    def state_meta(self) -> dict:
        meta = super().state_meta()
        meta["scheme"] = self.scheme_name
        version, _ = self._service.telemetry()
        meta["plan_version"] = version
        meta["obs_seen"] = self._service.observations_seen()
        # the sketch identity rides along so a restore into a differently-
        # sketched store fails loudly instead of mixing sketch spaces
        sk = self._store.sketch
        meta["sketch"] = None if sk is None else sk.name
        meta["sketch_dim"] = None if sk is None else sk.d_out
        meta["sketch_seed"] = None if sk is None else sk.seed
        return meta

    def load_state(self, meta: dict, arrays: dict) -> None:
        scheme = meta.get("scheme", self.scheme_name)
        if scheme != self.scheme_name:
            raise ValueError(
                f"checkpoint was written by scheme {scheme!r}; this sampler "
                f"is {self.scheme_name!r} — a cross-scheme restore would mix "
                "incompatible plan/store semantics"
            )
        sk = self._store.sketch
        have = (
            (None if sk is None else sk.name),
            (None if sk is None else sk.d_out),
            (None if sk is None else sk.seed),
        )
        want = (
            meta.get("sketch"),
            meta.get("sketch_dim"),
            meta.get("sketch_seed"),
        )
        if want != have:
            raise ValueError(
                f"checkpointed sketch state {want} != this sampler's sketch "
                f"{have}: a (name, dim, seed) mismatch would scatter new "
                "updates into a different sketch space than the restored G"
            )
        super().load_state(meta, arrays)  # rng + the exact live plan
        self._store.load(arrays["store_G"])
        from repro_torch.fl.planner import VersionedPlan

        self._service.restore(
            VersionedPlan(self._plan, int(meta["plan_version"])),
            obs_seen=int(meta["obs_seen"]),
        )

    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        del round_idx
        self._swap_freshest()  # round boundary: adopt the freshest plan
        return self._draw_from_plan(self._plan, available)

    def sample_overselect(
        self,
        round_idx: int,
        n_draws: int,
        available: Optional[np.ndarray] = None,
    ) -> SampleResult:
        del round_idx
        if not self.supports_overselect:
            raise NotImplementedError(
                f"{type(self).__name__} re-weights its draws itself; the "
                "urn-cyclic overselection re-weighting would not be unbiased "
                "for it — pick a plan-based scheme for scheduler='overselect'"
            )
        self._swap_freshest()  # the same round-boundary swap sample() does
        return self._draw_from_plan_overselect(self._plan, n_draws, available)
