# Adapted from src/repro/fl/scheduler.py: the deadline harvest buffer stays
# on the store's device.
"""Round schedulers: when a round closes and what happens to stragglers.

The round-closing rule is a pluggable policy, a :data:`SCHEDULERS` registry
(:func:`register_scheduler`) with three entries:

* ``"sync"`` — the synchronous round, the exact legacy path. Every hook is
  a no-op; a server with a :class:`SyncScheduler` attached trains
  bit-identically to one with no scheduler at all.
* ``"deadline"`` — rounds close after a fixed deadline against a simulated
  per-client :class:`LatencyModel`, drawn pure in ``(seed, t)`` exactly
  like :mod:`repro_torch.fl.population`'s masks (same ``SeedSequence``
  keying, disjoint stream tag), so a resumed service replays identical
  lateness. Stragglers are **not dropped**: their aggregation mass falls
  back on the current global model this round (the eq. 3 stale term
  mid-round drops use), but their computed updates land in a *harvest
  buffer* — a clone of the engine's device rows — and scatter into the
  **next** round's :class:`~repro_torch.fl.gradient_store.GradientStore`
  with a staleness discount (through the SRP kernel when the store is
  sketched). The buffer rides every checkpoint and kills/resumes
  bit-identically.
* ``"overselect"`` — FedAvg-style overselection: draw ``m · (1 + β)``
  clients, aggregate the first ``m`` draws. The extra draws re-use the
  plan's urns cyclically and each draw carries ``w_k / c_k``, so the
  draw-time re-weighting stays exactly unbiased for any eq. (8) plan (see
  ``ClientSampler.sample_overselect``). The discarded surplus draws'
  realized mass moves to the stale term.

The scheduler slots into ``FederatedServer.run_round``'s named phases::

    availability → begin_round (harvest scatter) → draw → resolve
    (lateness) → drop resolution → local work → collect (harvest late
    updates) → observe (on-time survivors only)

Per-round telemetry lands in ``RoundRecord.n_late`` / ``n_harvested``.
"""
from __future__ import annotations

import inspect
from typing import Optional

import numpy as np
import torch

from repro_torch.core.registry import Registry
from repro_torch.core.types import SampleResult
from repro_torch.device import resolve_device
from repro_torch.fl.population import _round_rng
from repro_torch.launch.mesh import ShardedRows

#: SeedSequence stream tag for latency draws — disjoint from the population
#: module's availability (0x41) / dropout (0x44) / phase (0x50) streams, so
#: attaching a deadline scheduler never shifts a scenario's churn.
_LAT_TAG = 0x4C


class LatencyModel:
    """Simulated per-client round latency, pure in ``(seed, t)``.

    Latencies are in units of the round deadline: every client draws a base
    response time ``u ~ U[0, 1)`` and, independently per round, is a
    straggler with probability ``straggle_frac`` — stragglers add
    ``slow_factor``. With the default ``deadline=1.0`` and
    ``slow_factor >= 1`` the split is exact: fast clients never miss the
    deadline, stragglers always do — so a round can lose every participant
    to lateness yet must not raise ``EmptyRoundError``.

    One ``SeedSequence((seed, tag, t))`` generator per round, base draw
    first then the straggler Bernoulli, so a resumed service replays the
    identical lateness without the model appearing in any checkpoint.
    """

    def __init__(
        self,
        n_clients: int,
        *,
        seed: int = 0,
        straggle_frac: float = 0.3,
        slow_factor: float = 2.0,
    ):
        if n_clients <= 0:
            raise ValueError("n_clients must be positive")
        if not 0.0 <= straggle_frac <= 1.0:
            raise ValueError(f"straggle_frac must be in [0, 1], got {straggle_frac}")
        if slow_factor < 0:
            raise ValueError(f"slow_factor must be >= 0, got {slow_factor}")
        self.n_clients = int(n_clients)
        self.seed = int(seed)
        self.straggle_frac = float(straggle_frac)
        self.slow_factor = float(slow_factor)

    def latencies(self, t: int) -> np.ndarray:
        """(n,) f64 latencies for round ``t``, deterministic in (seed, t)."""
        rng = _round_rng(self.seed, _LAT_TAG, t)
        base = rng.random(self.n_clients)
        slow = rng.random(self.n_clients) < self.straggle_frac
        return base + slow * self.slow_factor


class RoundScheduler:
    """Base scheduler: every hook the exact no-op of the legacy sync round."""

    #: registry / checkpoint identity (cross-scheduler restores fail loudly)
    name: str = "sync"

    def __init__(self, n_clients: int, m: int, *, seed: int = 0):
        if n_clients <= 0 or m <= 0:
            raise ValueError("n_clients and m must be positive")
        self.n_clients = int(n_clients)
        self.m = int(m)
        self.seed = int(seed)

    def required_slots(self, m: int) -> int:
        """Engine slot count — the padded client axis the engine stages."""
        return int(m)

    def begin_round(self, t: int, sampler) -> int:
        """Round prologue; returns how many buffered late updates were
        scattered into the sampler's gradient store (``n_harvested``)."""
        del t, sampler
        return 0

    def draw(self, t: int, sampler, available: Optional[np.ndarray]) -> SampleResult:
        """The round's client draw — the legacy call shape by default (the
        one-argument call without a mask)."""
        return sampler.sample(t) if available is None else sampler.sample(t, available)

    def n_late_extra(self) -> int:
        """Draws discarded at draw time (overselection surplus); 0 here."""
        return 0

    def resolve(
        self, t: int, distinct: np.ndarray, weights: np.ndarray, stale_weight: float
    ) -> tuple[np.ndarray, float, np.ndarray]:
        """Apply the round-closing rule *before* drop resolution.

        Returns ``(weights, stale_weight, late)`` — ``late`` a boolean mask
        over ``distinct`` marking participants whose update misses this
        round's aggregation (weight zeroed, mass gone stale) but will be
        harvested by :meth:`collect`. All-no-op here.
        """
        del t
        return weights, stale_weight, np.zeros(distinct.shape, dtype=bool)

    def collect(self, t: int, client_ids: np.ndarray, updates) -> None:
        """Buffer the late participants' computed updates for the next round."""
        del t, client_ids, updates

    # -- checkpointable state ------------------------------------------------
    def state_arrays(self) -> dict:
        return {}

    def state_meta(self) -> dict:
        return {"scheduler": self.name}

    def load_state(self, meta: dict, arrays: dict) -> None:
        got = meta.get("scheduler", self.name)
        if got != self.name:
            raise ValueError(
                f"checkpoint was written by scheduler {got!r}; this server "
                f"runs {self.name!r} — a cross-scheduler restore would mix "
                "incompatible harvest/lateness semantics"
            )
        del arrays


class SyncScheduler(RoundScheduler):
    """The synchronous round — the exact legacy path (every hook no-op)."""

    name = "sync"


class DeadlineScheduler(RoundScheduler):
    """Deadline rounds with straggler harvesting into the next round's store.

    Per round: :meth:`resolve` draws the :class:`LatencyModel` and marks
    participants past ``deadline`` late — their weight is zeroed and falls
    on the stale term, but :meth:`collect` keeps a clone of their computed
    device rows and the *next* round's :meth:`begin_round` scatters them
    into the sampler's gradient store scaled by ``harvest_discount``
    (decay-free: only the harvested rows change). ``device`` holds the
    buffer, the store's device; the default ``"cuda"`` raises without a
    GPU. It is a runtime argument, not a spec option.
    """

    name = "deadline"

    def __init__(
        self,
        n_clients: int,
        m: int,
        *,
        seed: int = 0,
        deadline: float = 1.0,
        straggle_frac: float = 0.3,
        slow_factor: float = 2.0,
        harvest_discount: float = 0.5,
        device="cuda",
    ):
        super().__init__(n_clients, m, seed=seed)
        if deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        if not 0.0 <= harvest_discount <= 1.0:
            raise ValueError(
                f"harvest_discount must be in [0, 1], got {harvest_discount}"
            )
        self.deadline = float(deadline)
        self.harvest_discount = float(harvest_discount)
        self.model = LatencyModel(
            n_clients, seed=seed, straggle_frac=straggle_frac, slow_factor=slow_factor
        )
        self.device = resolve_device(device)
        self._clear()

    def _clear(self) -> None:
        self._harvest_ids = np.empty(0, np.int64)
        self._harvest_vals = torch.zeros((0, 0), dtype=torch.float32, device=self.device)

    def begin_round(self, t: int, sampler) -> int:
        del t
        ids, vals = self._harvest_ids, self._harvest_vals
        if ids.size == 0:
            return 0
        self._clear()
        store = getattr(sampler, "gradient_store", None)
        if store is None:
            # plan-free sampler: nothing consumes late similarity updates
            return 0
        store.scatter_scaled(ids, vals, scale=self.harvest_discount)
        return int(ids.size)

    def resolve(self, t, distinct, weights, stale_weight):
        lat = self.model.latencies(t)[np.asarray(distinct, np.int64)]
        late = lat > self.deadline
        if late.any():
            stale_weight = float(stale_weight + weights[late].sum())
            weights = np.where(late, 0.0, weights)
        return weights, stale_weight, late

    def collect(self, t, client_ids, updates) -> None:
        del t
        # a clone on the buffer's device: it must survive the next engine
        # dispatch independent of the engine's output buffers
        self._harvest_ids = np.asarray(client_ids, np.int64).copy()
        if isinstance(updates, ShardedRows):  # a sharded round's rows, gathered
            updates = updates.gather(self.device)
        self._harvest_vals = torch.as_tensor(updates).to(
            self.device, torch.float32, copy=True
        )

    # -- checkpointable state ------------------------------------------------
    def state_arrays(self) -> dict:
        # host copies only here, for the bundle; keys are always present
        # (0-size when empty): restores take tree keys from the caller and
        # shapes from disk
        return {
            "harvest_ids": self._harvest_ids,
            "harvest_vals": self._harvest_vals.cpu().numpy(),
        }

    def load_state(self, meta: dict, arrays: dict) -> None:
        super().load_state(meta, {})
        ids = np.asarray(arrays["harvest_ids"], np.int64)
        vals = torch.as_tensor(arrays["harvest_vals"])
        if ids.shape[0] != vals.shape[0]:
            raise ValueError(
                f"checkpointed harvest buffer is inconsistent: {ids.shape[0]} "
                f"ids for {vals.shape[0]} update rows"
            )
        self._harvest_ids = ids
        self._harvest_vals = vals.to(self.device, torch.float32, copy=True)


class OverselectScheduler(RoundScheduler):
    """Sample ``m·(1+β)`` clients, aggregate the first ``m`` draws.

    Over all ``m·(1+β)`` weighted draws ``E[ω_i]`` equals the scheme's
    exact target for any eq. (8) plan; the surplus draws' realized mass
    then moves to the stale term — the resolution a mid-round drop
    receives, reported as ``n_late`` telemetry.
    """

    name = "overselect"

    def __init__(self, n_clients: int, m: int, *, seed: int = 0, beta: float = 0.5):
        super().__init__(n_clients, m, seed=seed)
        if beta <= 0:
            raise ValueError(f"beta must be > 0, got {beta}")
        self.beta = float(beta)
        self.n_extra = max(1, int(np.ceil(beta * m)))
        self._last_discarded = 0

    def draw(self, t, sampler, available):
        res = sampler.sample_overselect(t, self.m + self.n_extra, available)
        if res.draw_weights is None:
            raise RuntimeError(
                f"{type(sampler).__name__}.sample_overselect returned no "
                "per-draw weights; overselection thinning needs them"
            )
        clients, w = res.clients, res.draw_weights
        keep = min(self.m, int(clients.size))
        agg = np.zeros(res.agg_weights.shape[0])
        np.add.at(agg, clients[:keep], w[:keep])
        self._last_discarded = int(clients.size) - keep
        return SampleResult(
            clients=clients[:keep],
            agg_weights=agg,
            stale_weight=float(res.stale_weight + w[keep:].sum()),
            draw_weights=np.asarray(w[:keep]),
        )

    def n_late_extra(self) -> int:
        return self._last_discarded


#: name -> scheduler class with the uniform ``(n_clients, m, *, seed=0,
#: **options)`` constructor; ``SchedulerSpec`` sections resolve through this.
SCHEDULERS = Registry(
    "scheduler",
    {
        "sync": SyncScheduler,
        "deadline": DeadlineScheduler,
        "overselect": OverselectScheduler,
    },
)

register_scheduler = SCHEDULERS.register


def build_scheduler(spec, *, n_clients: int, m: int, device="cuda") -> RoundScheduler:
    """Resolve a :class:`~repro_torch.fl.experiment.SchedulerSpec` (or its
    dict form) through :data:`SCHEDULERS` and construct the scheduler.

    ``device`` goes to schedulers that hold device state (the deadline
    harvest buffer); like a sampler's, it is never a spec option.
    """
    from repro_torch.fl.experiment import SchedulerSpec

    spec = SchedulerSpec.from_dict(spec) if isinstance(spec, dict) else spec
    factory = SCHEDULERS.get(spec.name)
    params = inspect.signature(factory).parameters
    accepted = set(params) - {"self", "n_clients", "m", "seed", "device"}
    unknown = set(spec.options) - accepted
    if unknown:
        raise ValueError(
            f"scheduler {spec.name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted options: {sorted(accepted)}"
        )
    kwargs = dict(spec.options)
    if "device" in params:
        kwargs["device"] = device
    return factory(n_clients, m, seed=spec.seed, **kwargs)


__all__ = [
    "LatencyModel",
    "RoundScheduler",
    "SyncScheduler",
    "DeadlineScheduler",
    "OverselectScheduler",
    "SCHEDULERS",
    "register_scheduler",
    "build_scheduler",
]
