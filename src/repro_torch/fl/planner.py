# Adapted from src/repro/fl/planner.py.
"""Asynchronous re-clustering planner: plan *building* off the critical path.

The paper's server "overlaps re-clustering with client local work"
(Section 5): while the sampled clients run their N local steps for round
``t+1``, the server rebuilds the Algorithm 2 plan from round ``t``'s
representative gradients. The seed implementation rebuilt synchronously
inside ``observe_updates`` — O(n²d) distances + O(n³) Ward on the round's
critical path.

This module is the producer side of the split:

* :class:`PlanService` owns versioned :class:`SamplingPlan`\\ s and accepts
  *observations* (snapshots of the gradient store) that trigger rebuilds.
* ``mode="sync"`` rebuilds inline — today's numerics, kept as the parity
  reference.
* ``mode="async"`` hands the snapshot to a single background worker and
  returns immediately; the consumer (the sampler) swaps in the freshest
  *completed* plan at each round boundary via :meth:`poll`. Pending
  snapshots are latest-wins: a rebuild that has not started yet is replaced
  by a newer observation, so the worker never queues up stale work.

A plan's ``version`` is the index of the observation it incorporates
(0 = the cold-start plan built before any updates). The *lag* reported by
:meth:`telemetry` is ``observations seen − version of the active plan`` —
0 in sync mode by construction, ≥ 0 under async overlap; it lands in
``RoundRecord.plan_lag_rounds`` since the server observes once per round.

Rebuild scheduling is either a fixed cadence (``rebuild_every=k``, the
default) or *measured*: with ``drift_threshold`` set, every observation
computes a cheap on-device drift statistic — the assignment churn of the
fresh representative gradients against the live plan's clusters
(:class:`AssignmentDriftMonitor`) — and a rebuild runs only when it crosses
the threshold. The statistic is O(n·k·d) (one nearest-centroid pass), so
deciding *not* to rebuild costs a vanishing fraction of the O(n²d + n³)
rebuild it skips. Both the drift value and the wall-clock cost of each
rebuild are exposed (:meth:`PlanService.last_drift` /
:meth:`PlanService.last_build_ms`) and land in
``RoundRecord.plan_drift`` / ``plan_build_ms``.

The module is dependency-light (stdlib, numpy, torch, ``repro_torch.core``): the
snapshot is opaque to the service — device arrays pass straight through to
``build_fn`` without a host round-trip (the drift monitor, when enabled,
consumes them on device too). The gradient store hands out a copy of its
tensor as the snapshot, so a snapshot read by the worker while the engine
scatters new updates into the store stays consistent. The worker thread
makes a CUDA snapshot's card its current device before it builds: a
thread starts on card 0, and a sharded store's snapshot lives on the
mesh's lead card.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.types import SamplingPlan

BuildFn = Callable[[Any], SamplingPlan]


class AssignmentDriftMonitor:
    """Assignment churn of fresh gradients vs the live plan's clusters.

    At each rebuild the monitor freezes the plan's cluster structure as a
    set of centroids (per-cluster means of the snapshot rows the plan
    grouped, ``plan.cluster_of >= 0``) plus the baseline nearest-centroid
    assignment of that snapshot. :meth:`drift` then measures, for a fresh
    snapshot, the fraction of rows whose nearest centroid changed — 0.0
    when the gradients still sort into the same clusters (identical
    assignments ⇒ identical statistic), growing monotonically with label
    churn. Plans with no cluster structure (all-dedicated urns) and the
    never-baselined cold start report ``inf``: when churn cannot be
    measured, the trigger errs toward rebuilding.

    With availability tracking on, each observation also carries the
    tracker's active-client mask, and :meth:`drift` adds a *churn* term: the
    fraction of clients whose active bit flipped since the baseline. Fleet
    turnover alone (clients aging out of the presence window, newcomers
    crossing the threshold) then triggers a rebuild even when the surviving
    clients' gradients have not drifted — a mask of ``None`` means the full
    fleet, so the term is 0 whenever tracking is off.

    All heavy ops run through :mod:`repro_torch.core.clustering.device`, so a
    device-resident snapshot never round-trips to host (only the scalar
    comes back). State swaps are atomic single-attribute stores, safe for
    the async planner's reader (observe) / writer (worker) threads.
    """

    def __init__(self):
        self._state: Optional[tuple[Any, np.ndarray]] = None  # (centroids, baseline)
        self._active: Optional[np.ndarray] = None  # baseline mask; None = full fleet

    def rebaseline(
        self, snapshot: Any, plan: SamplingPlan, active: Optional[np.ndarray] = None
    ) -> None:
        """Freeze ``plan``'s clusters over ``snapshot`` as the new baseline.

        ``active`` is the availability mask the rebuild was restricted to
        (None = full fleet); it becomes the reference for the churn term.
        """
        from repro_torch.core.clustering.device import (
            cluster_centroids,
            nearest_centroid_labels,
        )

        self._active = None if active is None else np.asarray(active, dtype=bool).copy()
        labels = None if plan.cluster_of is None else np.asarray(plan.cluster_of)
        if labels is None or not (labels >= 0).any():
            self._state = None
            return
        k = int(labels.max()) + 1
        centroids = cluster_centroids(snapshot, labels, k)
        self._state = (centroids, nearest_centroid_labels(snapshot, centroids))

    def _churn(self, active: Optional[np.ndarray]) -> float:
        """Fraction of clients whose active bit flipped since the baseline."""
        if active is None and self._active is None:
            return 0.0
        if self._active is not None:
            ref = self._active
            new = (
                np.ones_like(ref) if active is None else np.asarray(active, dtype=bool)
            )
        else:
            new = np.asarray(active, dtype=bool)
            ref = np.ones_like(new)
        return float(np.mean(new != ref))

    def drift(self, snapshot: Any, active: Optional[np.ndarray] = None) -> float:
        """Assignment churn of ``snapshot`` plus the fleet-turnover term."""
        from repro_torch.core.clustering.device import nearest_centroid_labels

        state = self._state
        if state is None:
            return float("inf")
        centroids, baseline = state
        fresh = nearest_centroid_labels(snapshot, centroids)
        return float(np.mean(fresh != baseline)) + self._churn(active)


@dataclasses.dataclass(frozen=True)
class VersionedPlan:
    """A sampling plan stamped with the observation index it incorporates."""

    plan: SamplingPlan
    version: int  # number of observations folded in; 0 = cold-start plan


class PlanService:
    """Versioned plan producer, synchronous or overlapped.

    ``build_fn(snapshot) -> SamplingPlan`` is the (expensive) Algorithm 1/2
    plan constructor; ``initial_input`` is the snapshot for the version-0
    cold-start plan, built inline at construction either way.

    ``rebuild_every=k`` sets the re-clustering cadence: only every k-th
    observation triggers a rebuild (the skipped ones still advance the
    observation counter, so :meth:`telemetry` lag — and therefore
    ``RoundRecord.plan_version`` / ``plan_lag_rounds`` — records exactly
    which observation the active plan incorporates and how far it trails).
    Snapshots are cumulative store states, so skipping intermediates loses
    nothing: the k-th snapshot contains every update since the last rebuild.

    ``drift_threshold`` replaces the fixed cadence with the measured
    trigger: each observation computes the drift statistic and a rebuild
    fires iff ``drift >= drift_threshold``. A threshold of 0.0 degenerates
    to rebuild-on-any-churn (and, since the cold start reports ``inf``,
    fires on the first observation); thresholds > 1 never fire on a
    measurable plan. Mutually exclusive with a non-default
    ``rebuild_every`` — the two scheduling policies would silently mask
    each other. Requires array-like snapshots (the drift monitor computes
    nearest-centroid assignments over them).

    ``drift_monitor`` injects the :class:`AssignmentDriftMonitor` that the
    trigger reads (a fresh one by default). Without ``drift_threshold`` an
    injected monitor decides nothing: it is only re-baselined at each build.
    """

    MODES = ("sync", "async")

    def __init__(
        self,
        build_fn: BuildFn,
        *,
        mode: str = "sync",
        initial_input: Any = None,
        rebuild_every: int = 1,
        drift_threshold: Optional[float] = None,
        drift_monitor: Optional[AssignmentDriftMonitor] = None,
    ):
        if mode not in self.MODES:
            raise ValueError(f"unknown planner mode {mode!r}; choose from {self.MODES}")
        if rebuild_every < 1:
            raise ValueError(f"rebuild_every must be >= 1, got {rebuild_every}")
        if drift_threshold is not None:
            if drift_threshold < 0:
                raise ValueError(
                    f"drift_threshold must be >= 0, got {drift_threshold}"
                )
            if rebuild_every != 1:
                raise ValueError(
                    "drift_threshold and rebuild_every are alternative rebuild "
                    f"schedules; got both (rebuild_every={rebuild_every}) — "
                    "pick one"
                )
        self.mode = mode
        self.rebuild_every = int(rebuild_every)
        self.drift_threshold = None if drift_threshold is None else float(drift_threshold)
        self._build_fn = build_fn
        self._monitor = (
            (drift_monitor or AssignmentDriftMonitor())
            if drift_threshold is not None
            else drift_monitor
        )
        self._cond = threading.Condition()
        self._current = VersionedPlan(self._timed_build(initial_input), version=0)
        if self._monitor is not None:
            self._monitor.rebaseline(initial_input, self._current.plan)
        self._completed: Optional[VersionedPlan] = None  # built, not yet polled
        # latest-wins (version, snapshot, active-mask) awaiting the worker
        self._pending: Optional[tuple[int, Any, Optional[np.ndarray]]] = None
        self._building = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._obs_seen = 0
        self._rebuilds = 0
        self._last_drift = -1.0
        self._worker: Optional[threading.Thread] = None

    def _timed_build(self, snapshot: Any) -> SamplingPlan:
        """Run ``build_fn`` and record its wall-clock cost (telemetry)."""
        t0 = time.perf_counter()
        plan = self._build_fn(snapshot)
        self._last_build_ms = (time.perf_counter() - t0) * 1e3
        return plan

    # -- producer side ------------------------------------------------------
    def observe(self, snapshot: Any, active: Optional[np.ndarray] = None) -> None:
        """Record one observation and (re)build the plan from ``snapshot``.

        Sync: builds inline; :meth:`poll` returns the fresh plan immediately
        after. Async: enqueues (replacing any not-yet-started snapshot) and
        returns without blocking — the round for ``t+1`` proceeds while the
        worker rebuilds. With ``rebuild_every=k``, observations that are not
        a multiple of k only advance the counter (no rebuild, no snapshot
        retained). With ``drift_threshold`` set, the drift statistic decides
        instead: below threshold the observation only advances the counter.

        ``active`` is the availability tracker's current active-client mask
        (None = full fleet). It feeds the drift monitor's churn term and is
        re-baselined alongside the plan, so fleet turnover counts toward the
        rebuild trigger; the build itself reads its cluster restriction from
        the sampler at build time (the tracker replaces its score tensor,
        never mutates it, so the worker sees a consistent mask).
        """
        self._raise_pending_error()
        self._obs_seen += 1
        if self.drift_threshold is not None:
            self._last_drift = self._monitor.drift(snapshot, active)
            if not self._last_drift >= self.drift_threshold:
                return
        elif self._obs_seen % self.rebuild_every != 0:
            return
        if self.mode == "sync":
            plan = self._timed_build(snapshot)
            if self._monitor is not None:
                self._monitor.rebaseline(snapshot, plan, active)
            with self._cond:
                self._completed = VersionedPlan(plan, self._obs_seen)
                self._rebuilds += 1
            return
        with self._cond:
            if self._closed:
                raise RuntimeError("PlanService is closed")
            self._pending = (self._obs_seen, snapshot, active)
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._worker_loop, name="plan-service", daemon=True
                )
                self._worker.start()
            self._cond.notify_all()

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._closed and self._pending is None:
                    return
                version, snapshot, active = self._pending
                self._pending = None
                self._building = True
            try:
                dev = getattr(snapshot, "device", None)
                if isinstance(dev, torch.device) and dev.type == "cuda":
                    torch.cuda.set_device(dev)
                plan = self._timed_build(snapshot)
                if self._monitor is not None:
                    self._monitor.rebaseline(snapshot, plan, active)
            except BaseException as e:  # surfaced on the next observe/poll/flush
                with self._cond:
                    self._error = e
                    self._building = False
                    self._cond.notify_all()
                continue  # keep servicing newer snapshots (latest-wins)
            with self._cond:
                # one worker + latest-wins pending => versions are monotone
                self._completed = VersionedPlan(plan, version)
                self._building = False
                self._rebuilds += 1
                self._cond.notify_all()

    # -- consumer side ------------------------------------------------------
    def poll(self) -> Optional[VersionedPlan]:
        """Take the freshest *completed* plan, or None if nothing new.

        Called at round boundaries: non-blocking, so an async rebuild still
        in flight simply leaves the previous plan active for one more round.
        """
        self._raise_pending_error()
        with self._cond:
            vp, self._completed = self._completed, None
            if vp is not None:
                self._current = vp
            return vp

    def current(self) -> VersionedPlan:
        """The active (last polled-in) versioned plan."""
        with self._cond:
            return self._current

    def telemetry(self) -> tuple[int, int]:
        """(version of active plan, observations not yet reflected in it)."""
        with self._cond:
            return self._current.version, self._obs_seen - self._current.version

    def observations_seen(self) -> int:
        """Total observations recorded (the rebuild-cadence counter)."""
        with self._cond:
            return self._obs_seen

    def rebuilds_done(self) -> int:
        """Completed plan rebuilds, excluding the version-0 cold start."""
        with self._cond:
            return self._rebuilds

    def last_build_ms(self) -> float:
        """Wall-clock ms of the most recent completed ``build_fn`` call."""
        return self._last_build_ms

    def last_drift(self) -> float:
        """Drift statistic of the most recent observation.

        -1.0 until the first observation or when the drift trigger is
        disabled (``drift_threshold=None``); otherwise the assignment-churn
        fraction in [0, 1], or ``inf`` for an unmeasurable plan.
        """
        return self._last_drift

    def restore(self, plan: VersionedPlan, *, obs_seen: int) -> None:
        """Reinstate a checkpointed (plan, observation-counter) state.

        The sampler was quiesced (flushed) before its state was exported, so
        restoring requires no rebuild to be pending or in flight — the
        service refuses otherwise rather than racing a stale worker build
        against the restored plan. The plan is adopted as it is: no rebuild
        runs.
        """
        with self._cond:
            if self._pending is not None or self._building:
                raise RuntimeError(
                    "cannot restore a PlanService with a rebuild pending or "
                    "in flight; flush() first"
                )
            if obs_seen < plan.version:
                raise ValueError(
                    f"obs_seen={obs_seen} < plan version {plan.version}: a plan "
                    "cannot incorporate observations that never happened"
                )
            self._current = plan
            self._completed = None
            self._obs_seen = int(obs_seen)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until no rebuild is pending or in flight.

        ``flush(); poll()`` forces async to the sync fixed point — the
        determinism tests pin async-forced-complete ≡ sync through this.
        """
        with self._cond:
            ok = self._cond.wait_for(
                lambda: (self._pending is None and not self._building) or self._error,
                timeout=timeout,
            )
            if not ok:
                raise TimeoutError("plan rebuild did not complete in time")
        self._raise_pending_error()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker; pending snapshots are abandoned."""
        with self._cond:
            self._closed = True
            self._pending = None
            self._cond.notify_all()
            worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout)

    def _raise_pending_error(self) -> None:
        with self._cond:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("plan rebuild failed in the planner worker") from err
