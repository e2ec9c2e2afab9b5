# Adapted from src/repro/fl/availability.py: the scores as a torch tensor on
# the sampler's device.
"""Availability history: per-client presence scores driving plan rebuilds.

An :class:`AvailabilityTracker` folds each round's availability mask plus
the drawn participants' response outcomes — on-time, late (straggled past
the deadline but delivered), or crashed — into one exponentially-decayed
presence score per client::

    score_i  ←  decay · score_i + (1 − decay) · signal_i

where ``signal_i`` is the availability mask (0/1) for undrawn clients and,
for drawn participants, the graded response outcome: 1.0 on-time,
``late_credit`` late, 0.0 crashed. Scores start at 1.0 (optimistic cold
start: the version-0 plan clusters everyone, exactly the paper's setting).

Consumers:

* :meth:`active_mask` (``score ≥ threshold``) restricts which clients the
  *clustering* step of a plan rebuild groups by similarity
  (``build_plan_algorithm2(cluster_mask=...)``). The plan itself still
  covers every client with its exact eq. (8) mass, so every drawn plan
  stays exactly unbiased over whatever clients turn out to be available.
* :class:`~repro_torch.fl.planner.AssignmentDriftMonitor` takes the mask as
  its churn term, so fleet turnover alone can trigger a rebuild.

The scores are an f32 tensor on ``device``. The fold is two rounded f32
products and one rounded add, each its own op, which is what the
reference's numpy backend computes: the port's scores are bit-equal to
``backend="numpy"``. The reference's jax backend contracts the fold into
one fused multiply-add with ``1 − decay`` taken in f32, so it may differ
from both in the last bit (the reference's own test holds its two
backends to atol 1e-7). The tensor is replaced each fold, never mutated,
so an async plan rebuild reading :meth:`active_mask` sees one consistent
round. The scores and the fold's knobs ride every server checkpoint; a
restored tensor lands on the tracker's device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


class AvailabilityTracker:
    """Exponentially-decayed per-client presence scores in [0, 1].

    ``decay`` is the history half-life knob (0.9 ≈ the last ~10 rounds
    dominate); ``threshold`` is the :meth:`active_mask` cut; ``late_credit``
    is the graded signal a straggler earns — between a crash (0.0) and an
    on-time report (1.0), so a persistently-slow client decays toward
    ``late_credit`` instead of toward dead. ``device`` holds the scores;
    the default ``"cuda"`` raises without a GPU.
    """

    def __init__(
        self,
        n_clients: int,
        *,
        decay: float = 0.9,
        threshold: float = 0.25,
        late_credit: float = 0.5,
        device="cuda",
    ):
        if n_clients <= 0:
            raise ValueError("n_clients must be positive")
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        if not 0.0 <= threshold <= 1.0:
            raise ValueError(f"threshold must be in [0, 1], got {threshold}")
        if not 0.0 <= late_credit <= 1.0:
            raise ValueError(f"late_credit must be in [0, 1], got {late_credit}")
        self.n_clients = int(n_clients)
        self.decay = float(decay)
        self.threshold = float(threshold)
        self.late_credit = float(late_credit)
        self.rounds_seen = 0
        self.device = resolve_device(device)
        # the numpy backend's two f32 constants: decay, and 1 − decay taken
        # in f64 then rounded
        self._d = torch.tensor(np.float32(self.decay), device=self.device)
        self._c = torch.tensor(np.float32(1.0 - self.decay), device=self.device)
        self._scores = torch.ones(self.n_clients, dtype=torch.float32, device=self.device)

    # -- per-round update ----------------------------------------------------
    def update(
        self,
        mask: Optional[np.ndarray],
        *,
        on_time: Optional[np.ndarray] = None,
        late: Optional[np.ndarray] = None,
        crashed: Optional[np.ndarray] = None,
    ) -> None:
        """Fold one round's availability + response outcomes into the scores.

        ``mask`` is the round's availability mask ((n,) bool; ``None`` = the
        fixed-population all-available case). ``on_time``/``late``/
        ``crashed`` are disjoint id arrays over the round's drawn
        participants; their graded outcome overrides the mask signal — a
        drawn client that crashed mid-round scores 0.0 even though the
        availability mask admitted it.
        """
        signal = (
            np.ones(self.n_clients, np.float32)
            if mask is None
            else np.asarray(mask, dtype=bool).astype(np.float32)
        )
        if signal.shape != (self.n_clients,):
            raise ValueError(
                f"availability mask shape {signal.shape} != ({self.n_clients},)"
            )
        for ids, value in (
            (on_time, 1.0),
            (late, self.late_credit),
            (crashed, 0.0),
        ):
            if ids is not None and len(ids):
                signal[np.asarray(ids, np.int64)] = np.float32(value)
        sig = torch.from_numpy(signal).to(self.device)
        # two rounded products, then the rounded add: no fused multiply-add
        kept = torch.mul(self._scores, self._d)
        fresh = torch.mul(sig, self._c)
        self._scores = torch.add(kept, fresh)
        self.rounds_seen += 1

    # -- consumers -----------------------------------------------------------
    def scores(self) -> np.ndarray:
        """Host f32 copy of the (n,) presence scores."""
        return self._scores.cpu().numpy()

    def active_mask(self, threshold: Optional[float] = None) -> np.ndarray:
        """Boolean (n,) mask of clients worth clustering: score ≥ threshold."""
        thr = self.threshold if threshold is None else float(threshold)
        return self.scores() >= np.float32(thr)

    def min_score(self) -> float:
        """The fleet's weakest presence score (``RoundRecord.avail_score_min``)."""
        return float(self.scores().min())

    # -- checkpointable state ------------------------------------------------
    def state_arrays(self) -> dict:
        return {"avail_scores": self._scores}

    def state_meta(self) -> dict:
        return {
            "decay": self.decay,
            "threshold": self.threshold,
            "late_credit": self.late_credit,
            "rounds_seen": self.rounds_seen,
        }

    def load_state(self, meta: dict, arrays: dict) -> None:
        """Restore a checkpointed score buffer; bit-exact continuation.

        The decay constants are identity: restoring a history folded under
        different knobs would silently re-grade the whole fleet, so a
        mismatch raises instead. ``avail_scores`` may be a tensor or numpy;
        it lands on the tracker's device as f32.
        """
        have = (self.decay, self.threshold, self.late_credit)
        want = (
            float(meta["decay"]),
            float(meta["threshold"]),
            float(meta["late_credit"]),
        )
        if have != want:
            raise ValueError(
                f"checkpointed availability knobs (decay, threshold, "
                f"late_credit)={want} != this tracker's {have}; the decayed "
                "history is only meaningful under the knobs that produced it"
            )
        scores = torch.as_tensor(arrays["avail_scores"])
        if tuple(scores.shape) != (self.n_clients,):
            raise ValueError(
                f"checkpointed scores shape {tuple(scores.shape)} != ({self.n_clients},)"
            )
        self._scores = scores.to(self.device, torch.float32, copy=True)
        self.rounds_seen = int(meta["rounds_seen"])


__all__ = ["AvailabilityTracker"]
