"""The FL orchestrator: sample → local work → unbiased aggregation.

Port of ``src/repro/fl/server.py``. Faithful to the paper's protocol:
  * each round, the sampler draws ``l_1..l_m`` (with multiplicity) from the
    host numpy rng;
  * only the *distinct* sampled clients do local work (a client drawn twice
    trains once and carries weight 2/m);
  * aggregation is the realized weighted sum (eq. 3/4), through the
    aggregate kernel;
  * similarity-based samplers get the representative gradients
    ``θ_i^{t+1} - θ^t`` of the sampled clients after the round as a device
    tensor, scattered into their gradient store.

Two execution engines (``FLConfig.engine``): ``"batched"`` (default, all
clients as one stacked step, :mod:`repro_torch.fl.engine`) and
``"compat"`` (a per-client loop, the numerics reference).

Continuous service: a :class:`~repro_torch.fl.population.PopulationProcess`
turns the fixed-n loop into a service whose rounds run as named phases —

  availability mask → begin_round (harvest scatter) → draw → resolve
  (lateness) → drop resolution → local work + aggregate → collect (late
  updates) → observe (on-time survivors) → availability fold

— where the sampler conditions its draw on the round's availability mask
(re-normalized urns, unbiased over the available set), a client that
vanishes mid-round keeps its padded slot but carries weight 0 with its
eq. 3 mass falling back on the current global model, and
``EmptyRoundError`` fires only when *all* realized mass is gone. A
:class:`~repro_torch.fl.scheduler.RoundScheduler` makes the round-closing
rule pluggable (deadline stragglers harvested into the next round's store,
overselection), and an
:class:`~repro_torch.fl.availability.AvailabilityTracker` folds each
round's mask and outcomes into presence scores.

Crash tolerance: :meth:`FederatedServer.checkpoint` bundles the full
server state (params, server and sampler rng states, plan matrices,
gradient store, scheduler and tracker state, history cursor) through
:mod:`repro_torch.checkpoint` on a ``checkpoint_every`` cadence, and
:meth:`FederatedServer.resume` reconstructs it so a killed service
continues bit-identically to an uninterrupted run. The bundle layout is
the reference's, so a bundle written by either package resumes in the
other. A restored plan is loaded, not rebuilt.

Mesh sharding (``FLConfig.mesh_spec``): the batched engine splits the
round's client axis, and its staged data, over the mesh's data groups, one
process driving every card (:mod:`repro_torch.launch.mesh`,
:mod:`repro_torch.fl.engine`). The mesh's lead device must be the server's
``device``: it holds the global model.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.samplers.base import ClientSampler
from repro_torch.data.federated import FederatedDataset
from repro_torch.device import resolve_device
from repro_torch.fl.aggregation import aggregate_round, flatten_params
from repro_torch.fl.client import draw_batch_indices, local_update
from repro_torch.fl.engine import ENGINES, staged_bytes
from repro_torch.fl.history import History, RoundRecord
from repro_torch.fl.population import PopulationProcess
from repro_torch.launch.mesh import check_lead, resolve_fl_mesh
from repro_torch.models.simple import accuracy, classification_loss
from repro_torch.optim.base import Optimizer


@dataclasses.dataclass
class FLConfig:
    n_rounds: int = 100
    n_local_steps: int = 50  # N in the paper
    batch_size: int = 50  # B in the paper
    fedprox_mu: float = 0.0
    eval_every: int = 1
    seed: int = 0
    engine: str = "batched"  # any repro_torch.fl.engine.ENGINES name
    # The batched engine pins every client's (padded) data on the device. If
    # that exceeds this budget the server falls back to the compat loop with
    # a warning — both paths are numerically equivalent.
    max_staged_bytes: int = 2 << 30
    # Mesh for the batched engine's client axis: None (single-device,
    # default), "auto" (every visible card on "data"), "DxM" / (D, M) host
    # mesh shapes, or a repro_torch.launch.mesh.Mesh. See
    # repro_torch.launch.mesh.resolve_fl_mesh. Ignored by "compat".
    mesh_spec: "str | tuple[int, int] | None" = None
    # Crash tolerance: every `checkpoint_every` completed rounds (and on a
    # service stop request) the full server state is written to
    # `checkpoint_path` through repro_torch.checkpoint. 0 / None disables.
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None


class EmptyRoundError(ValueError):
    """The sampler produced nothing to aggregate for a round: zero distinct
    clients, or distinct clients whose realized weights sum to zero."""


class FederatedServer:
    def __init__(
        self,
        dataset: FederatedDataset,
        sampler: ClientSampler,
        init_params: dict,
        optimizer: Optimizer,
        config: FLConfig,
        loss_fn: Callable = classification_loss,
        acc_fn: Callable = accuracy,
        population: Optional[PopulationProcess] = None,
        scheduler=None,
        availability=None,
        *,
        device="cuda",
    ):
        """``init_params`` is a dict of tensors (see
        :func:`repro_torch.models.simple.params_from_numpy`); it is moved to
        ``device``. ``population`` (a
        :class:`~repro_torch.fl.population.PopulationProcess`, optional)
        draws each round's availability and mid-round dropout.
        ``scheduler`` (a :class:`~repro_torch.fl.scheduler.RoundScheduler`,
        optional) makes the round-closing rule pluggable — None keeps the
        synchronous round exactly. ``availability`` (an
        :class:`~repro_torch.fl.availability.AvailabilityTracker`, optional)
        folds each round's mask + participant outcomes into per-client
        presence scores; attach it to the sampler too
        (``StoreBackedSampler.attach_availability``) to restrict plan
        rebuilds to the recently-seen fleet. Both checkpoint with the
        server state when present."""
        engine_factory = ENGINES.get(config.engine)  # precise unknown-name error
        self.device = resolve_device(device)
        self.dataset = dataset
        self.sampler = sampler
        self.params = {k: v.to(self.device, torch.float32) for k, v in init_params.items()}
        self.opt = optimizer
        self.cfg = config
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        self.population = population
        self.scheduler = scheduler
        self.availability = availability
        self._rng = np.random.default_rng(config.seed)
        self.history = History()
        x_test, y_test = dataset.global_test()
        self._x_test = torch.as_tensor(x_test, dtype=torch.float32, device=self.device)
        self._y_test = torch.as_tensor(y_test, dtype=torch.int64, device=self.device)
        # classes each client can contribute, for the per-round class count
        self._client_classes = [np.unique(c.y_train) for c in dataset.clients]
        # the scheduler owns the engine's padded slot count (the built-ins
        # keep it at m — overselection thins at draw time)
        mesh = (
            resolve_fl_mesh(config.mesh_spec, device=self.device.type)
            if config.engine != "compat"
            else None
        )
        if mesh is not None:
            check_lead(mesh, self.device, "the server")
        slots = (
            sampler.m if scheduler is None else int(scheduler.required_slots(sampler.m))
        )
        if config.engine == "batched":
            # budget check against the *per-device* footprint: a mesh that
            # shards the client axis is how large datasets stay stageable
            need = staged_bytes(
                dataset, slots, config.n_local_steps, config.batch_size, mesh=mesh
            )
            if need > config.max_staged_bytes:
                fmt = lambda b: f"{b / 2**30:.2f} GiB" if b >= 2**30 else f"{b / 2**20:.2f} MiB"
                warnings.warn(
                    f"batched engine would stage {fmt(need)} of padded "
                    f"client data per device (budget {fmt(config.max_staged_bytes)}); "
                    "falling back to the compat loop — raise FLConfig.max_staged_bytes "
                    "or shard further via FLConfig.mesh_spec to override",
                    stacklevel=2,
                )
                engine_factory = ENGINES.get("compat")
                mesh = None  # the compat loop never shards
        self.mesh = mesh
        self._engine = engine_factory(dataset, slots, config, self.device, mesh)
        # service cursor: the next round to run. run()/resume() maintain it so
        # a restored server continues exactly where the checkpoint left off.
        self._start_round = 0
        self._round_cursor = 0
        self._closed = False

    # ------------------------------------------------------------------
    def _round_compat(self, distinct: np.ndarray, weights: np.ndarray, stale_weight: float):
        """Reference path: one client at a time."""
        cfg = self.cfg
        client_models, losses, updates_flat = [], [], []
        flat_global = flatten_params(self.params)
        for cid in distinct:
            data = self.dataset.clients[int(cid)]
            idx = draw_batch_indices(
                self._rng, data.n_train, cfg.n_local_steps, cfg.batch_size, self.device
            )
            new_p, loss = local_update(
                self.params,
                torch.as_tensor(data.x_train, dtype=torch.float32, device=self.device),
                torch.as_tensor(data.y_train, dtype=torch.int64, device=self.device),
                idx,
                self.loss_fn,
                self.opt,
                cfg.fedprox_mu,
            )
            client_models.append(new_p)
            losses.append(float(loss))
            updates_flat.append(flatten_params(new_p) - flat_global)
        new_params = aggregate_round(self.params, client_models, weights, stale_weight)
        return new_params, torch.stack(updates_flat), np.asarray(losses)

    # -- round phases --------------------------------------------------------
    # run_round = availability → draw → drop resolution → local work +
    # aggregate → observe → availability fold. Drop resolution happens
    # *before* engine dispatch because the engine fuses local work and
    # aggregation into one step: a dropped client still occupies its padded
    # slot (stable shapes, stable rng stream) but its aggregation weight is
    # zeroed and its mass falls back on the current global model (eq. 3's
    # stale term) — exactly "the device computed, the result never arrived".

    def _phase_availability(self, t: int) -> tuple[Optional[np.ndarray], int]:
        """(mask, n_available); (None, -1) without a population process."""
        if self.population is None:
            return None, -1
        mask = self.population.available_mask(t)
        n_avail = int(mask.sum())
        if n_avail == 0:
            raise EmptyRoundError(
                f"round {t}: availability mask admits zero of "
                f"{self.population.n_clients} clients — nobody can be drawn"
            )
        return mask, n_avail

    def _phase_draw(self, t: int, available: Optional[np.ndarray]):
        """Sampler draw conditioned on availability; fails on empty draws."""
        if self.scheduler is not None:
            # the scheduler owns the draw shape (overselection draws
            # m·(1+β) and thins); its base draw is exactly the legacy call
            result = self.scheduler.draw(t, self.sampler, available)
        else:
            # no mask → the one-argument call, so custom samplers written
            # without availability conditioning keep working untouched
            result = (
                self.sampler.sample(t)
                if available is None
                else self.sampler.sample(t, available)
            )
        # sample() is the round boundary where planner-backed samplers swap
        # in the freshest completed plan — capture what this round drew from
        plan_version, plan_lag = self.sampler.plan_telemetry()
        distinct = result.unique_clients
        if distinct.size == 0:
            raise EmptyRoundError(
                f"round {t}: sampler {type(self.sampler).__name__} returned zero "
                "distinct clients — the plan has no mass anywhere"
                + (" on the available set" if available is not None else "")
                + "; nothing to train or aggregate"
            )
        weights = result.agg_weights[distinct]
        if weights.sum() <= 0:
            raise EmptyRoundError(
                f"round {t}: realized aggregation weights of the {distinct.size} "
                "distinct clients sum to zero — aggregating (and averaging the "
                "round loss) over them is undefined"
            )
        return result, distinct, weights, plan_version, plan_lag

    def _phase_drop_resolution(
        self,
        t: int,
        distinct: np.ndarray,
        weights: np.ndarray,
        stale_weight: float,
        late: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, float, np.ndarray]:
        """Zero dropped participants' weights; their mass goes stale.

        Returns ``(weights, stale_weight, dropped)`` — ``dropped`` is the
        boolean mask over ``distinct``. Raises :class:`EmptyRoundError` when
        every realized participant dropped (all realized mass is gone) —
        unless ``late`` marks scheduler-resolved stragglers among the
        survivors: their updates are merely delayed (harvested next round),
        so a round that lost all its mass to *lateness* proceeds as a
        stale-only aggregation instead of dying.
        """
        if self.population is None:
            return weights, stale_weight, np.zeros(distinct.shape, dtype=bool)
        dropped = self.population.dropout_mask(t, distinct)
        if not dropped.any():
            return weights, stale_weight, dropped
        live = weights[~dropped].sum()
        if live <= 0 and not (late is not None and (late & ~dropped).any()):
            raise EmptyRoundError(
                f"round {t}: all {distinct.size} realized participants dropped "
                "mid-round (or the survivors carry zero weight) — every bit of "
                "realized aggregation mass is gone; nothing arrived to aggregate"
            )
        # the aggregation is a plain weighted sum (no re-normalization), so a
        # dropped client's ω_i must land somewhere: it falls back on the
        # current global model, the same eq. 3 stale term uniform sampling uses
        stale_weight = float(stale_weight + weights[dropped].sum())
        weights = np.where(dropped, 0.0, weights)
        return weights, stale_weight, dropped

    def _phase_local_work(self, distinct, weights, stale_weight):
        """Local training + aggregation — one engine dispatch."""
        if self._engine is not None:
            return self._engine.run_round(
                self.params,
                distinct,
                weights,
                stale_weight,
                self._rng,
                self.loss_fn,
                self.opt,
                self.cfg.fedprox_mu,
            )
        return self._round_compat(distinct, weights, stale_weight)

    def _phase_eval(self, t: int) -> float:
        if t % self.cfg.eval_every != 0:
            return float("nan")
        with torch.no_grad():
            return float(self.acc_fn(self.params, self._x_test, self._y_test))

    def _rows(self, updates_flat: torch.Tensor, mask: np.ndarray) -> torch.Tensor:
        """The rows of ``updates_flat`` that ``mask`` (over distinct) keeps."""
        if mask.all():
            return updates_flat
        return updates_flat[torch.as_tensor(mask, device=updates_flat.device)]

    def run_round(self, t: int) -> RoundRecord:
        available, n_available = self._phase_availability(t)
        # scheduler prologue: flush last round's harvested straggler updates
        # into the gradient store *before* this round draws from it
        n_harvested = (
            int(self.scheduler.begin_round(t, self.sampler))
            if self.scheduler is not None
            else 0
        )
        result, distinct, weights, plan_version, plan_lag = self._phase_draw(
            t, available
        )
        stale_weight = result.stale_weight
        if self.scheduler is not None:
            # round-closing rule: mark stragglers late (weight → stale term,
            # update harvested below) before mid-round drops resolve
            weights, stale_weight, late = self.scheduler.resolve(
                t, distinct, weights, stale_weight
            )
        else:
            late = np.zeros(distinct.shape, dtype=bool)
        weights, stale_weight, dropped = self._phase_drop_resolution(
            t, distinct, weights, stale_weight, late=late
        )
        n_dropped = int(dropped.sum())
        # a participant that both straggled and crashed is a crash: the
        # result never arrived, so there is nothing to harvest either
        late = late & ~dropped
        n_late = int(late.sum())
        self.params, updates_flat, losses = self._phase_local_work(
            distinct, weights, stale_weight
        )
        if n_late and self.scheduler is not None:
            # harvest: late updates were computed (the engine ran their
            # padded slots) — the scheduler keeps a device clone of the rows
            self.scheduler.collect(t, distinct[late], self._rows(updates_flat, late))
        # observe: feed representative gradients back (Algorithm 2's input) —
        # on-time survivors only; a dropped client's update never reached the
        # server and a straggler's arrives next round via the harvest path
        keep = ~(dropped | late)
        contributing = distinct[keep]
        if contributing.size:
            self.sampler.observe_updates(contributing, self._rows(updates_flat, keep))
        # read after observe_updates: the drift statistic and any sync
        # rebuild for this round happen there
        plan_build_ms, plan_drift = self.sampler.plan_cost_telemetry()
        # availability fold: the mask plus this round's graded outcomes —
        # on-time 1.0, late late_credit, crashed 0.0 (see fl.availability)
        if self.availability is not None:
            self.availability.update(
                available,
                on_time=contributing,
                late=distinct[late],
                crashed=distinct[dropped],
            )
            avail_score_min = self.availability.min_score()
        else:
            avail_score_min = -1.0
        classes = (
            np.unique(np.concatenate([self._client_classes[int(c)] for c in contributing]))
            if contributing.size
            else np.empty(0, np.int64)
        )
        agg_weights = result.agg_weights
        if n_dropped or n_late:
            agg_weights = np.array(agg_weights, dtype=np.float64, copy=True)
            agg_weights[distinct[dropped | late]] = 0.0
        live_mass = float(weights.sum())
        rec = RoundRecord(
            round=t,
            # dropped/late participants carry zero weight, so the round loss
            # averages over on-time survivors only; a round that lost every
            # participant to lateness aggregated stale-only mass — no loss
            train_loss=(
                float(np.average(losses, weights=weights)) if live_mass > 0 else float("nan")
            ),
            test_acc=self._phase_eval(t),
            n_distinct_clients=len(distinct),
            n_distinct_classes=len(classes),
            agg_weights=agg_weights,
            plan_version=plan_version,
            plan_lag_rounds=plan_lag,
            plan_build_ms=plan_build_ms,
            plan_drift=plan_drift,
            n_available=n_available,
            n_dropped=n_dropped,
            # n_late also counts draws the scheduler discarded at draw time
            # (overselection surplus); round_status tracks actual stragglers
            # and crashes only — planned surplus is not degradation
            n_late=n_late
            + (self.scheduler.n_late_extra() if self.scheduler is not None else 0),
            n_harvested=n_harvested,
            avail_score_min=avail_score_min,
            round_status="degraded" if (n_dropped or n_late) else "ok",
        )
        self.history.append(rec)
        self._round_cursor = t + 1
        return rec

    def run(
        self,
        on_round: Optional[Callable[[RoundRecord], None]] = None,
        *,
        should_stop: Optional[Callable[[], bool]] = None,
        skip_empty: bool = False,
    ) -> History:
        """Run rounds ``[start, n_rounds)``; returns the full :class:`History`.

        ``start`` is 0 for a fresh server and the checkpointed cursor after
        :meth:`resume`. ``on_round`` is called with each
        :class:`RoundRecord` as it lands.

        Service semantics: with ``FLConfig.checkpoint_every > 0`` (and a
        ``checkpoint_path``) the full server state is checkpointed on that
        cadence of completed rounds. ``should_stop`` is polled after each
        round — a SIGTERM-style stop flag; when it trips, a final checkpoint
        is written and the loop exits cleanly. ``skip_empty=True`` converts
        :class:`EmptyRoundError` rounds (everyone offline / everyone
        dropped) into placeholder ``round_status="empty"`` records instead
        of raising — a long-running service rides out a dead fleet; a batch
        experiment should still fail loudly.
        """
        cfg = self.cfg
        every = int(cfg.checkpoint_every or 0)
        for t in range(self._start_round, cfg.n_rounds):
            try:
                rec = self.run_round(t)
            except EmptyRoundError:
                if not skip_empty:
                    raise
                n_avail = (
                    int(self.population.available_mask(t).sum())
                    if self.population is not None
                    else -1
                )
                rec = RoundRecord(
                    round=t,
                    train_loss=float("nan"),
                    test_acc=float("nan"),
                    n_distinct_clients=0,
                    n_distinct_classes=0,
                    n_available=n_avail,
                    round_status="empty",
                )
                self.history.append(rec)
                self._round_cursor = t + 1
            if on_round is not None:
                on_round(rec)
            if every and cfg.checkpoint_path and (t + 1) % every == 0:
                self.checkpoint()
            if should_stop is not None and should_stop():
                if cfg.checkpoint_path:
                    self.checkpoint()
                break
        return self.history

    # -- crash tolerance -----------------------------------------------------
    # Server state = params + server rng + sampler state (rng, plan matrices,
    # gradient store, plan version / observation counter) + scheduler and
    # tracker state + round history. Arrays ride in the checkpoint's .npz
    # tree; JSON-shaped state (rng bit-generator dicts, the history records)
    # rides in its `extra` side-channel. The population process is absent:
    # its masks are pure functions of (seed, t), so a resumed server replays
    # the identical availability/dropout trajectory for free.

    def _state_tree(self) -> dict:
        tree = {"params": self.params, "sampler": self.sampler.state_arrays()}
        # optional subsystems checkpoint as their own sections, present only
        # when attached — restoring a bundle into a differently-configured
        # server fails on the missing/extra key instead of dropping state
        if self.scheduler is not None:
            tree["scheduler"] = self.scheduler.state_arrays()
        if self.availability is not None:
            tree["availability"] = self.availability.state_arrays()
        return tree

    def checkpoint(self, path: Optional[str] = None) -> str:
        """Write the full server state bundle; returns the path written.

        ``path`` defaults to ``FLConfig.checkpoint_path``. The sampler is
        quiesced first (:meth:`ClientSampler.prepare_state` — async planners
        flush their in-flight rebuild to the sync fixed point), so the
        bundle is always a consistent cut.
        """
        from repro_torch.checkpoint import save_checkpoint

        path = path or self.cfg.checkpoint_path
        if not path:
            raise ValueError(
                "no checkpoint path: pass one or set FLConfig.checkpoint_path"
            )
        self.sampler.prepare_state()
        extra = {
            "server_rng": self._rng.bit_generator.state,
            "sampler": self.sampler.state_meta(),
            "history": json.loads(self.history.to_json()),
        }
        if self.scheduler is not None:
            extra["scheduler"] = self.scheduler.state_meta()
        if self.availability is not None:
            extra["availability"] = self.availability.state_meta()
        save_checkpoint(path, self._state_tree(), step=self._round_cursor, extra=extra)
        return path

    def resume(self, path: Optional[str] = None) -> int:
        """Reconstruct mid-campaign state from a :meth:`checkpoint` bundle.

        Restores params (onto this server's device), server rng, the
        sampler's full state, the scheduler's and tracker's state and the
        round history, and positions :meth:`run` at the checkpointed
        cursor. Returns the round the server will run next. The restored
        plan is adopted as it is — no rebuild runs until the next
        observation. For sync/static-plan samplers the continuation is
        bit-identical to the uninterrupted run; async planners restore the
        exact sync fixed point the checkpoint captured.
        """
        from repro_torch.checkpoint import peek_meta, restore_checkpoint

        path = path or self.cfg.checkpoint_path
        if not path:
            raise ValueError(
                "no checkpoint path: pass one or set FLConfig.checkpoint_path"
            )
        # provenance first: a bundle written by a scheduler-/tracker-free
        # server must fail with WHY, not with a generic missing-leaf error
        _, preview = peek_meta(path)
        if self.scheduler is not None and "scheduler" not in preview:
            raise ValueError(
                "this server has a round scheduler attached but the "
                "checkpoint carries no scheduler section — it was written "
                "by a scheduler-free server"
            )
        if self.availability is not None and "availability" not in preview:
            raise ValueError(
                "this server tracks availability but the checkpoint "
                "carries no availability section — it was written by a "
                "tracker-free server"
            )
        # the scheduler subtree is variable-shaped (the harvest buffer holds
        # however many late updates the killed round produced)
        tree, step, extra = restore_checkpoint(
            path,
            self._state_tree(),
            dynamic_prefixes=("scheduler/",) if self.scheduler is not None else (),
        )
        self.params = tree["params"]
        self._rng.bit_generator.state = extra["server_rng"]
        self.sampler.load_state(extra["sampler"], tree["sampler"])
        if self.scheduler is not None:
            self.scheduler.load_state(extra["scheduler"], tree.get("scheduler", {}))
        if self.availability is not None:
            self.availability.load_state(
                extra["availability"], tree.get("availability", {})
            )
        self.history = History.from_json(json.dumps(extra["history"]))
        self._start_round = self._round_cursor = int(step)
        return int(step)

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Release the sampler's background resources; idempotent."""
        if not self._closed:
            self._closed = True
            self.sampler.close()

    def __enter__(self) -> "FederatedServer":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()
