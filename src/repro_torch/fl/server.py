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

Client churn: a :class:`~repro_torch.fl.population.PopulationProcess` turns
the fixed-n loop into a service whose rounds run as named phases —

  availability mask → draw → drop resolution → local work + aggregate
  → observe → availability fold

— where the sampler conditions its draw on the round's availability mask
(re-normalized urns, unbiased over the available set), a client that
vanishes mid-round keeps its padded slot but carries weight 0 with its
eq. 3 mass falling back on the current global model, and
``EmptyRoundError`` fires only when *all* realized mass is gone. An
:class:`~repro_torch.fl.availability.AvailabilityTracker` folds each
round's mask and outcomes into presence scores.

Not ported yet: round schedulers and checkpoint/resume (ROADMAP A10), and
mesh sharding (A13). The spec layer refuses the same at the spec's level
(``repro_torch.fl.experiment.build_experiment``).
"""
from __future__ import annotations

import dataclasses
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
    # Must stay None: mesh sharding is not ported.
    mesh_spec: "str | tuple[int, int] | None" = None


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
        ``availability`` (an
        :class:`~repro_torch.fl.availability.AvailabilityTracker`, optional)
        folds each round's mask + participant outcomes into per-client
        presence scores; attach it to the sampler too
        (``StoreBackedSampler.attach_availability``) to restrict plan
        rebuilds to the recently-seen fleet. ``scheduler`` must be None:
        round schedulers are not ported (ROADMAP A10)."""
        if scheduler is not None:
            raise NotImplementedError(
                "round schedulers are not ported (ROADMAP A10); pass scheduler=None"
            )
        if config.mesh_spec is not None:
            raise NotImplementedError("FLConfig.mesh_spec is not ported; leave it None")
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
        self.availability = availability
        self._rng = np.random.default_rng(config.seed)
        self.history = History()
        x_test, y_test = dataset.global_test()
        self._x_test = torch.as_tensor(x_test, dtype=torch.float32, device=self.device)
        self._y_test = torch.as_tensor(y_test, dtype=torch.int64, device=self.device)
        # classes each client can contribute, for the per-round class count
        self._client_classes = [np.unique(c.y_train) for c in dataset.clients]
        slots = sampler.m
        if config.engine == "batched":
            need = staged_bytes(dataset, slots, config.n_local_steps, config.batch_size)
            if need > config.max_staged_bytes:
                warnings.warn(
                    f"batched engine would stage {need / 2**20:.2f} MiB of padded "
                    f"client data (budget {config.max_staged_bytes / 2**20:.2f} MiB); "
                    "falling back to the compat loop — raise "
                    "FLConfig.max_staged_bytes to override",
                    stacklevel=2,
                )
                engine_factory = ENGINES.get("compat")
        self._engine = engine_factory(dataset, slots, config, self.device)
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
        self, t: int, distinct: np.ndarray, weights: np.ndarray, stale_weight: float
    ) -> tuple[np.ndarray, float, np.ndarray]:
        """Zero dropped participants' weights; their mass goes stale.

        Returns ``(weights, stale_weight, dropped)`` — ``dropped`` is the
        boolean mask over ``distinct``. Raises :class:`EmptyRoundError` when
        every realized participant dropped (all realized mass is gone).
        """
        if self.population is None:
            return weights, stale_weight, np.zeros(distinct.shape, dtype=bool)
        dropped = self.population.dropout_mask(t, distinct)
        if not dropped.any():
            return weights, stale_weight, dropped
        if weights[~dropped].sum() <= 0:
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

    def run_round(self, t: int) -> RoundRecord:
        available, n_available = self._phase_availability(t)
        result, distinct, weights, plan_version, plan_lag = self._phase_draw(
            t, available
        )
        weights, stale_weight, dropped = self._phase_drop_resolution(
            t, distinct, weights, result.stale_weight
        )
        n_dropped = int(dropped.sum())
        self.params, updates_flat, losses = self._phase_local_work(
            distinct, weights, stale_weight
        )
        # observe: feed representative gradients back (Algorithm 2's input) —
        # survivors only (drop resolution leaves at least one); a dropped
        # client's update never reached the server
        contributing = distinct[~dropped]
        if n_dropped:
            keep = torch.as_tensor(~dropped, device=updates_flat.device)
            updates_flat = updates_flat[keep]
        self.sampler.observe_updates(contributing, updates_flat)
        # read after observe_updates: the drift statistic and any sync
        # rebuild for this round happen there
        plan_build_ms, plan_drift = self.sampler.plan_cost_telemetry()
        # availability fold: the mask plus this round's graded outcomes —
        # on-time 1.0, crashed 0.0 (see fl.availability)
        if self.availability is not None:
            self.availability.update(
                available, on_time=contributing, crashed=distinct[dropped]
            )
            avail_score_min = self.availability.min_score()
        else:
            avail_score_min = -1.0
        classes = np.unique(
            np.concatenate([self._client_classes[int(c)] for c in contributing])
        )
        agg_weights = result.agg_weights
        if n_dropped:
            agg_weights = np.array(agg_weights, dtype=np.float64, copy=True)
            agg_weights[distinct[dropped]] = 0.0
        rec = RoundRecord(
            round=t,
            # dropped participants carry zero weight, so the round loss
            # averages over the survivors only
            train_loss=float(np.average(losses, weights=weights)),
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
            avail_score_min=avail_score_min,
            round_status="degraded" if n_dropped else "ok",
        )
        self.history.append(rec)
        return rec

    def run(
        self,
        on_round: Optional[Callable[[RoundRecord], None]] = None,
        *,
        skip_empty: bool = False,
    ) -> History:
        """Run rounds ``[0, n_rounds)``; returns the full :class:`History`.

        ``on_round`` is called with each :class:`RoundRecord` as it lands.
        ``skip_empty=True`` converts :class:`EmptyRoundError` rounds
        (everyone offline / everyone dropped) into placeholder
        ``round_status="empty"`` records instead of raising — a
        long-running service rides out a dead fleet; a batch experiment
        should still fail loudly.
        """
        for t in range(self.cfg.n_rounds):
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
            if on_round is not None:
                on_round(rec)
        return self.history

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
