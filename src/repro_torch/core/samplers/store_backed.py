"""Shared base for gradient-store-backed, plan-rebuilding samplers.

Port of ``src/repro/core/samplers/store_backed.py``. Updates scatter into a
device-resident :class:`repro_torch.fl.gradient_store.GradientStore`, a
:class:`repro_torch.fl.planner.PlanService` rebuilds the plan
(synchronously or on a background worker, on a fixed cadence or a measured
drift trigger), and the freshest completed plan is swapped in at each round
boundary. Subclasses implement :meth:`StoreBackedSampler._build_plan`.

The store's sketch stage (``sketch`` / ``sketch_dim``) is seeded with the
sampler's ``seed``, as in the reference. Not ported yet: the sharded store,
availability-restricted rebuilds and checkpointing of the store (ROADMAP
A10, A13).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.samplers.clustered import ClusteredSampler
from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


class StoreBackedSampler(ClusteredSampler):
    """Gradient-store + plan-service machinery shared by rebuild schemes."""

    consumes_updates = True

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
        # constructor, before ClusteredSampler.__init__ sets these
        self.population = population
        self.m = int(m)
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
        super().__init__(population, self._service.current().plan, seed=seed)

    def _build_plan(self, G) -> SamplingPlan:
        """Map the gradient block (n, d') to this scheme's sampling plan."""
        raise NotImplementedError

    def _swap_freshest(self) -> None:
        vp = self._service.poll()
        if vp is not None:
            self.set_plan(vp.plan)

    def observe_updates(self, client_ids, updates) -> None:
        """Scatter the round's updates into the store and trigger a rebuild.

        ``updates`` may be the engine's device tensor; it is scattered on the
        device and the plan service receives a snapshot of G.
        """
        if tuple(updates.shape) != (len(client_ids), self.update_dim):
            raise ValueError(
                f"updates shape {tuple(updates.shape)} != ({len(client_ids)}, {self.update_dim})"
            )
        self._store.update(client_ids, updates)
        self._service.observe(self._store.snapshot())
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

    def sample(self, round_idx: int) -> SampleResult:
        del round_idx
        self._swap_freshest()  # round boundary: adopt the freshest plan
        return self._draw_from_plan(self._plan)
