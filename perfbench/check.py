"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the reference works out, held to the cell's limit.

* ``loss_gap`` — each checked round's mean local loss, |program − reference|
  over |reference|, the worst round.
* ``first_gap`` — the first round's aggregate update θ¹ − θ⁰ (the first
  gradient as the round applies it, read from the global model's state
  after the round), by the worst leaf: the gap between the two per-leaf
  norms over the larger of the reference's norm of that leaf and of the
  median leaf.
* ``change_gap`` — the same of θᴿ − θ⁰ after the checked rounds.
  Leaves whose reference update is under a thousandth of the median
  leaf's (a key's bias under the softmax, which moves by round-off alone)
  are left out of both, by that rule and not by name.
* ``sketch_gap`` — the program's whole store after each checked round,
  every column of every row: a client's row against the reference's sketch
  of its own latest update of that client, the widest |program − reference|
  over the row's expected RMS, ‖u‖/√d′ of the reference's update u; a row
  of a client not yet observed has to be exactly 0 (else the gap is
  infinite).
* ``plan_mismatch`` — entries of each checked plan (integer tokens) that
  differ from the reference's plan of the program's store, which
  ``sketch_gap`` has judged entry by entry.
* ``draw_mismatch`` — drawn clients that differ from the reference's draw.
"""
from __future__ import annotations

import numpy as np

#: a leaf whose reference update is under this share of the median leaf's
#: moves by round-off alone and is not compared
NOUGHT = 1e-3


def kept_leaves(ref: np.ndarray) -> np.ndarray:
    ref = np.asarray(ref, np.float64)
    return ref >= NOUGHT * np.median(ref)


def leaf_gap(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray) -> float:
    prog, ref = np.asarray(prog, np.float64)[keep], np.asarray(ref, np.float64)[keep]
    floor = np.maximum(ref, np.median(ref))
    return float(np.max(np.abs(prog - ref) / floor))


def loss_gap(prog, ref) -> float:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if not np.all(np.isfinite(prog)):
        return float("inf")
    return float(np.max(np.abs(prog - ref) / np.abs(ref)))


def latest_rows(sketches, n_rounds: int) -> list:
    """sketches: (round, client, row, RMS) of each observation in order ->
    for each round, {client: (row, RMS)} of every client observed up to
    it, its latest observation (the store overwrites a row)."""
    out, rows = [], {}
    for r in range(n_rounds):
        rows.update({c: (row, rms) for t, c, row, rms in sketches if t == r})
        out.append(dict(rows))
    return out


def stores_of(sketches, n_rounds: int, n_clients: int, d_prime: int) -> list:
    """The (n_clients, d′) store after each round that ``sketches`` make."""
    out = []
    for rows in latest_rows(sketches, n_rounds):
        G = np.zeros((n_clients, d_prime))
        for c, (row, _) in rows.items():
            G[c] = np.asarray(row, np.float64)
        out.append(G)
    return out


def sketch_gap(stores, expected) -> float:
    """stores: the program's (n, d′) store after each checked round;
    expected: :func:`latest_rows` of the reference's sketches."""
    worst = 0.0
    for G, want in zip(stores, expected):
        G = np.asarray(G, np.float64)
        for i in range(G.shape[0]):
            if i not in want:
                if np.any(G[i] != 0):
                    return float("inf")
                continue
            r, rms = want[i]
            gap = float(np.max(np.abs(G[i] - np.asarray(r, np.float64)))) / rms if rms > 0 else float("inf")
            worst = max(worst, gap)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number with a limit within it, {name: {"value", "limit"}}).
    A number the cell's limits leave out is not compared: it has no upper
    reading (``perfbench/limits/<cell>.json`` says why)."""
    out, ok = {}, True
    for name in sorted(n for n in numbers if n in limits):
        v, lim = numbers[name], limits[name]
        out[name] = {"value": v, "limit": lim}
        ok &= bool(np.isfinite(v) and v <= lim)
    return ok, out
