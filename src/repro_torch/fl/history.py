# Copied from src/repro/fl/history.py.
"""Per-round FL run telemetry.

Serialization round-trips: ``RoundRecord.to_dict``/``from_dict`` and
``History.to_json``/``from_json`` are exact inverses — ``agg_weights``
survives as an optional JSON list of f64 (f64 → repr → f64 is lossless),
so the sweep layer's :class:`~repro_torch.fl.sweep.RunStore` can persist one
record per JSONL line and rebuild the identical ``History`` on read.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class RoundRecord:
    round: int
    train_loss: float  # global federated loss (eq. 1) or local-mean proxy
    test_acc: float
    n_distinct_clients: int
    n_distinct_classes: int
    agg_weights: np.ndarray | None = None
    # planner telemetry: version of the sampling plan this round drew from,
    # and how many observed rounds it trailed by (0 under the sync planner;
    # >= 0 when re-clustering overlaps client local work, see fl.planner)
    plan_version: int = 0
    plan_lag_rounds: int = 0
    # rebuild-cost telemetry (plan-rebuilding samplers only): wall-clock ms
    # of the most recent completed plan build, and the drift statistic the
    # planner measured this round (assignment churn in [0, 1], or inf when
    # unmeasurable). -1.0 = not applicable (plan-free sampler / drift
    # trigger disabled).
    plan_build_ms: float = -1.0
    plan_drift: float = -1.0
    # continuous-service telemetry (see repro_torch.fl.population): how many
    # clients the availability mask admitted this round (-1 = no population
    # process, the paper's fixed-n behaviour), how many realized
    # participants vanished mid-round / straggled past the deadline, and
    # the round's resolution: "ok" (everyone reported), "degraded" (>= 1
    # drop, the survivors' zero-weight-slot aggregation went through) or
    # "empty" (a skipped EmptyRound under a service loop's skip policy)
    n_available: int = -1
    n_dropped: int = 0
    # round-scheduler telemetry (see repro_torch.fl.scheduler): participants that
    # straggled past the deadline (plus overselection draws discarded at
    # draw time), and late updates harvested into this round's gradient
    # store from the previous round's stragglers
    n_late: int = 0
    n_harvested: int = 0
    # availability-tracker telemetry: the fleet's weakest presence score
    # after this round's fold (-1.0 = no tracker attached)
    avail_score_min: float = -1.0
    round_status: str = "ok"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.agg_weights is not None:
            d["agg_weights"] = np.asarray(self.agg_weights, dtype=np.float64).tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RoundRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"RoundRecord.from_dict: unknown key(s) {sorted(unknown)}; "
                f"accepted keys: {sorted(fields)}"
            )
        kw = dict(d)
        if kw.get("agg_weights") is not None:
            kw["agg_weights"] = np.asarray(kw["agg_weights"], dtype=np.float64)
        return cls(**kw)


@dataclasses.dataclass
class History:
    records: list[RoundRecord] = dataclasses.field(default_factory=list)

    def append(self, rec: RoundRecord) -> None:
        self.records.append(rec)

    def series(self, field: str) -> np.ndarray:
        return np.array([getattr(r, field) for r in self.records])

    def rolling(self, field: str, window: int = 50) -> np.ndarray:
        """Rolling mean, as used for the paper's training-loss figures."""
        x = self.series(field)
        if len(x) < 1:
            return x
        kernel = np.ones(min(window, len(x))) / min(window, len(x))
        return np.convolve(x, kernel, mode="valid")

    def to_json(self, *, include_agg_weights: bool = True) -> str:
        recs = [r.to_dict() for r in self.records]
        if not include_agg_weights:
            for d in recs:
                d.pop("agg_weights", None)
        return json.dumps(recs)

    @classmethod
    def from_json(cls, s: str) -> "History":
        recs = json.loads(s)
        if not isinstance(recs, list):
            raise ValueError(f"History.from_json expects a JSON list, got {type(recs).__name__}")
        return cls(records=[RoundRecord.from_dict(d) for d in recs])
