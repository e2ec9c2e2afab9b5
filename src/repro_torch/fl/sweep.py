# Adapted from src/repro/fl/sweep.py: cells run on a device the caller names.
"""Campaign orchestration: one declarative sweep → a figure-ready CSV.

Every figure in the paper is a *campaign*, not a run — Figures 1–2 and the
Appendix-D ablations are mean±std curves over many seeds and heterogeneity
settings. :class:`SweepSpec` makes that one JSON value on top of
:class:`~repro_torch.fl.experiment.ExperimentSpec`::

    {
      "base":  {"data": {...}, "sampler": {"name": "md", "m": 10},
                "train": {"n_rounds": 20}},
      "axes":  {"sampler.name": ["md", "algorithm2"],
                "data.options.alpha": [0.001, 0.01, 10.0]},
      "n_seeds": 5,
      "root_seed": 0
    }

``axes`` maps dotted paths into the base spec's dict form to lists of
values (a path may also name a whole section, e.g. ``"sampler"`` with a
list of sampler dicts); the grid is their cartesian product in declaration
order, replicated ``n_seeds`` times (seed axis innermost). Per-replicate
seeds derive deterministically from
``np.random.SeedSequence(root_seed).spawn(n_seeds)``: replicate ``r``
spawns one (data, sampler, train) seed triple that is *shared by every
grid cell* of that replicate, so scheme comparisons are paired (common
random numbers — every sampler sees the same partition and batch stream
per replicate) while replicates get independent streams (no seed
monoculture). An axis that explicitly sweeps a seed path wins over the
derivation.

Cell identity is a stable content hash of the fully resolved
:class:`ExperimentSpec` dict — reordering axes, renaming the store, or
resuming cannot change what a cell *is*. Execution goes through a
:class:`RunStore` (one directory: ``manifest.json`` + one JSONL of
:class:`~repro_torch.fl.history.RoundRecord` lines per cell + an atomically
written summary marker): completed cells are skipped on re-invoke, so a
killed sweep resumes where it left off and the collated output is
bit-identical to an uninterrupted run. Independent cells optionally fan
out over a process pool (``run_sweep(..., workers=k)``), and
:func:`collate` aggregates the per-cell summaries into tidy CSVs — one
row per cell plus mean±std over the seed axis, the exact table behind the
paper's figures.

The device is a runtime argument (``run_sweep(..., device="cuda")``), like
the store directory: it never enters a spec, so one sweep names the same
cells, with the same ids, in this package and in the reference.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import time
import warnings
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.fl.experiment import ExperimentSpec, load_spec_dict
from repro_torch.fl.history import History, RoundRecord

#: dotted paths that receive the SeedSequence-derived per-replicate seeds
#: (in this order); an axis sweeping one of these paths overrides it.
SEED_PATHS: tuple[str, ...] = ("data.options.seed", "sampler.seed", "train.seed")


# --------------------------------------------------------------------------
# dotted-path overrides
# --------------------------------------------------------------------------
def set_by_path(d: dict, path: str, value) -> None:
    """Set ``d[a][b][c] = value`` for ``path == "a.b.c"``, creating dicts."""
    keys = path.split(".")
    for k in keys[:-1]:
        nxt = d.setdefault(k, {})
        if not isinstance(nxt, dict):
            raise ValueError(
                f"override path {path!r}: {k!r} is a {type(nxt).__name__}, "
                "not a dict — cannot descend into it"
            )
        d = nxt
    d[keys[-1]] = value


def _get_by_path(d: dict, path: str):
    """``d[a][b][c]`` for ``path == "a.b.c"``; None when any level is absent."""
    for k in path.split("."):
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d


def override_label(path: str, value) -> str:
    """Human-readable value label for CSV columns / emit rows.

    Scalars stringify; a dict override (a whole spec section) is labelled
    by its ``name`` when it has one, else by compact sorted JSON.
    """
    if isinstance(value, dict):
        return str(value["name"]) if "name" in value else json.dumps(value, sort_keys=True)
    return str(value)


def cell_group_label(overrides: dict) -> str:
    """``alpha=0.01/name=md`` style label for one grid point's overrides."""
    return "/".join(
        f"{path.split('.')[-1]}={override_label(path, v)}" for path, v in overrides.items()
    )


# --------------------------------------------------------------------------
# SweepSpec
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One fully resolved point of the campaign grid."""

    cell_id: str  # stable content hash of the resolved spec
    grid_index: int  # which grid point (axes product, declaration order)
    seed_index: int  # which replicate
    overrides: dict  # dotted path -> value, this grid point's axis choices
    spec: ExperimentSpec  # the resolved experiment (seeds already injected)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A whole campaign as one declarative, JSON-round-trippable value."""

    base: ExperimentSpec
    axes: dict = dataclasses.field(default_factory=dict)
    n_seeds: int = 1
    root_seed: int = 0

    def __post_init__(self):
        if self.n_seeds < 1:
            raise ValueError(f"n_seeds must be >= 1, got {self.n_seeds}")
        for path, values in self.axes.items():
            if not isinstance(path, str) or not path:
                raise ValueError(f"axis path {path!r} must be a non-empty string")
            if not isinstance(values, (list, tuple)) or len(values) == 0:
                raise ValueError(
                    f"axis {path!r} must map to a non-empty list of values, "
                    f"got {values!r}"
                )

    @classmethod
    def from_dict(cls, d: dict) -> "SweepSpec":
        if not isinstance(d, dict):
            raise ValueError(f"SweepSpec.from_dict expects a dict, got {type(d).__name__}")
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(
                f"SweepSpec.from_dict: unknown key(s) {sorted(unknown)}; "
                f"accepted keys: {sorted(fields)}"
            )
        if "base" not in d:
            raise ValueError("SweepSpec.from_dict: missing required key(s) ['base']")
        kw = dict(d)
        if not isinstance(kw["base"], ExperimentSpec):
            kw["base"] = ExperimentSpec.from_dict(kw["base"])
        return cls(**kw)

    def to_dict(self) -> dict:
        return {
            "base": self.base.to_dict(),
            "axes": {k: list(v) for k, v in self.axes.items()},
            "n_seeds": self.n_seeds,
            "root_seed": self.root_seed,
        }

    @classmethod
    def from_json(cls, s: str) -> "SweepSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_arg(cls, arg: str) -> "SweepSpec":
        """Parse a CLI ``--sweep`` argument: inline JSON or a JSON file path."""
        return cls.from_dict(load_spec_dict(arg))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    # -- expansion ----------------------------------------------------------
    def _grid(self) -> list[dict]:
        """Cartesian product of axes in declaration order (stable)."""
        points = [{}]
        for path, values in self.axes.items():
            points = [{**pt, path: v} for pt in points for v in values]
        return points

    def replicate_seeds(self) -> list[dict]:
        """The per-replicate ``{seed path: seed}`` triples, one per seed index.

        Deterministic in ``root_seed`` and ``n_seeds`` only — independent of
        the axes, so every grid cell of replicate ``r`` shares the same
        (data, sampler, train) seeds: paired comparisons across schemes.
        """
        children = np.random.SeedSequence(self.root_seed).spawn(self.n_seeds)
        return [
            dict(zip(SEED_PATHS, (int(s) for s in child.generate_state(len(SEED_PATHS)))))
            for child in children
        ]

    def cells(self) -> list[SweepCell]:
        """Expand the campaign: grid outer, seed axis innermost.

        The expansion is deterministic (axes declaration order × seed
        index) and each cell's identity is the content hash of its fully
        resolved spec dict — duplicate resolved specs are an error, not a
        silent collision in the store.
        """
        seeds = self.replicate_seeds()
        cells: list[SweepCell] = []
        seen: dict[str, tuple[int, int]] = {}
        clobbered: set[str] = set()
        for gi, overrides in enumerate(self._grid()):
            for si, seed_triple in enumerate(seeds):
                d = self.base.to_dict()
                # overrides land first (deep-copied: axis values are shared
                # across cells), then the derived seeds — so a "sampler"
                # axis of whole section dicts still gets per-replicate
                # seeds. Only an axis sweeping the exact seed path wins
                # over the derivation.
                for path, value in overrides.items():
                    set_by_path(d, path, copy.deepcopy(value))
                for path, seed in seed_triple.items():
                    if path not in self.axes:
                        pinned = _get_by_path(d, path)
                        if pinned not in (None, 0):
                            clobbered.add(path)
                        set_by_path(d, path, seed)
                spec = ExperimentSpec.from_dict(d)
                cid = cell_hash(spec)
                if cid in seen:
                    raise ValueError(
                        f"cells (grid {seen[cid]}) and (grid ({gi}, {si})) resolve "
                        f"to the identical spec (hash {cid}); axes "
                        f"{sorted(self.axes)} do not distinguish them"
                    )
                seen[cid] = (gi, si)
                cells.append(
                    SweepCell(
                        cell_id=cid,
                        grid_index=gi,
                        seed_index=si,
                        overrides=overrides,
                        spec=spec,
                    )
                )
        if clobbered:
            warnings.warn(
                f"seed(s) pinned at {sorted(clobbered)} are overwritten by the "
                "sweep's SeedSequence derivation; to pin a seed across "
                "replicates, sweep that exact path as a single-value axis",
                stacklevel=2,
            )
        return cells


def cell_hash(spec: Union[ExperimentSpec, dict]) -> str:
    """Stable content hash of a fully resolved spec (the cell's identity)."""
    d = spec.to_dict() if isinstance(spec, ExperimentSpec) else spec
    blob = json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# --------------------------------------------------------------------------
# summaries (the figure-level statistics of one run)
# --------------------------------------------------------------------------
#: summary fields aggregated (mean±std over the seed axis) by collate()
SUMMARY_STATS: tuple[str, ...] = (
    "final_loss",
    "first_loss",
    "final_acc",
    "mean_distinct_classes",
    "mean_distinct_clients",
    "rounds_to_acc",
    "agg_weight_var",
    "degraded_frac",
    "avail_time_to_acc",
)

#: test-accuracy threshold ``rounds_to_acc`` races schemes toward.
ACC_TARGET = 0.75


def rounds_to_accuracy(hist: History, rounds: int, target: float = ACC_TARGET) -> float:
    """First round count (1-based) at which test accuracy reaches ``target``.

    Censored runs (never reaching ``target``, or with no evaluated rounds)
    report ``rounds`` — a pessimistic, finite value, so mean±std over seeds
    stays well-defined for the time-to-accuracy race column.
    """
    acc = np.nan_to_num(hist.series("test_acc"), nan=-np.inf)
    hits = np.flatnonzero(acc >= target)
    return float(hits[0] + 1) if hits.size else float(rounds)


def agg_weight_variance(hist: History) -> float:
    """Σ_i Var_t(ω_i): total across-round variance of aggregation weights.

    The paper's quality axis for client selection — clustered/stratified
    schemes exist to shrink it at fixed E[ω_i] = p_i. NaN when the history
    carries no ``agg_weights`` telemetry or fewer than two rounds of it.
    """
    ws = [r.agg_weights for r in hist.records if r.agg_weights is not None]
    if len(ws) < 2:
        return float("nan")
    W = np.asarray(ws, dtype=np.float64)
    return float(W.var(axis=0, ddof=0).sum())


def degraded_fraction(hist: History) -> float:
    """Fraction of rounds that did not close cleanly (status != "ok").

    Counts both "degraded" rounds (mid-round drops and/or deadline
    stragglers among the realized participants — see
    ``RoundRecord.round_status``) and "empty" skipped rounds. The service-
    quality axis the round-scheduler sweep trades against time-to-accuracy.
    """
    status = [r.round_status for r in hist.records]
    if not status:
        return float("nan")
    return float(np.mean([s != "ok" for s in status]))


def availability_weighted_time_to_acc(
    hist: History, rounds: int, target: float = ACC_TARGET
) -> float:
    """Availability-weighted rounds-to-accuracy: Σ_{t<T_hit} a_t / n.

    Each round before the accuracy hit costs its *available fraction* of
    the fleet (``n_available / n_clients``; 1.0 for fixed-population rounds
    with ``n_available == -1``), so a scheme that reaches the target while
    most of the fleet is offline scores better than the plain round count
    suggests — it extracted its progress from fewer client-opportunities.
    Equals :func:`rounds_to_accuracy` exactly on a fixed population;
    censored runs integrate over all ``rounds`` like the unweighted race.
    """
    n_ref = max((r.n_distinct_clients for r in hist.records), default=0)
    n_avail = hist.series("n_available").astype(np.float64)
    # the fleet size: any round's n_available upper-bounds realized distinct
    # clients; with no population process every entry is -1 → weight 1.0
    n_fleet = float(max(n_avail.max(), n_ref, 1))
    w = np.where(n_avail < 0, 1.0, n_avail / n_fleet)
    t_hit = rounds_to_accuracy(hist, rounds, target)
    return float(w[: int(min(t_hit, len(w)))].sum())


def summarize_history(hist: History, rounds: int) -> dict:
    """The figure-level summary statistics of one run's History."""
    losses = hist.series("train_loss")
    roll = hist.rolling("train_loss", window=min(10, rounds))
    return {
        "final_loss": float(roll[-1]),
        "first_loss": float(losses[0]),
        "final_acc": float(np.nanmax(hist.series("test_acc")[-3:])),
        "mean_distinct_classes": float(hist.series("n_distinct_classes").mean()),
        "mean_distinct_clients": float(hist.series("n_distinct_clients").mean()),
        "rounds_to_acc": rounds_to_accuracy(hist, rounds),
        "agg_weight_var": agg_weight_variance(hist),
        "degraded_frac": degraded_fraction(hist),
        "avail_time_to_acc": availability_weighted_time_to_acc(hist, rounds),
    }


# --------------------------------------------------------------------------
# RunStore
# --------------------------------------------------------------------------
class RunStore:
    """One sweep's on-disk state: manifest + per-cell records + summaries.

    Layout::

        <root>/manifest.json            the SweepSpec (verified on reuse)
        <root>/cells/<id>.jsonl         one RoundRecord per line, streamed
        <root>/cells/<id>.summary.json  atomic completion marker + summary
        <root>/cells.csv                collated per-cell rows
        <root>/summary.csv              mean±std over the seed axis

    A cell is *complete* iff its summary marker exists (written via
    tmp + ``os.replace``, so a kill mid-cell leaves only a partial JSONL
    that the rerun truncates). Reusing a store for a different sweep is an
    error, not silent cross-contamination.
    """

    MANIFEST = "manifest.json"

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        (self.root / "cells").mkdir(parents=True, exist_ok=True)

    # -- manifest -----------------------------------------------------------
    def manifest_path(self) -> Path:
        return self.root / self.MANIFEST

    def write_manifest(self, sweep: SweepSpec) -> None:
        # JSON-normalize (tuples → lists) so the resume comparison sees
        # exactly what a round-tripped manifest contains
        d = json.loads(json.dumps(sweep.to_dict()))
        path = self.manifest_path()
        if path.exists():
            existing = json.loads(path.read_text())
            if existing != d:
                raise ValueError(
                    f"store at {self.root} was created for a different sweep "
                    "(manifest mismatch); use a fresh directory per campaign"
                )
            return
        # no sort_keys: axes declaration order IS the grid order, and the
        # manifest round-trip must preserve it cell-for-cell
        self._atomic_write(path, json.dumps(d, indent=2))

    def read_manifest(self) -> SweepSpec:
        path = self.manifest_path()
        if not path.exists():
            raise ValueError(f"store at {self.root} has no manifest — run a sweep into it first")
        return SweepSpec.from_dict(json.loads(path.read_text()))

    # -- per-cell files -----------------------------------------------------
    def records_path(self, cell_id: str) -> Path:
        return self.root / "cells" / f"{cell_id}.jsonl"

    def summary_path(self, cell_id: str) -> Path:
        return self.root / "cells" / f"{cell_id}.summary.json"

    def is_complete(self, cell_id: str) -> bool:
        return self.summary_path(cell_id).exists()

    def append_record(self, fh, rec: RoundRecord) -> None:
        fh.write(json.dumps(rec.to_dict()) + "\n")

    def finalize_cell(self, cell_id: str, summary: dict) -> None:
        """Atomically mark a cell complete with its summary statistics."""
        self._atomic_write(
            self.summary_path(cell_id), json.dumps(summary, sort_keys=True)
        )

    def read_summary(self, cell_id: str) -> dict:
        return json.loads(self.summary_path(cell_id).read_text())

    def read_history(self, cell_id: str) -> History:
        hist = History()
        with open(self.records_path(cell_id)) as fh:
            for line in fh:
                if line.strip():
                    hist.append(RoundRecord.from_dict(json.loads(line)))
        return hist

    def completed(self, cells: list[SweepCell]) -> list[SweepCell]:
        return [c for c in cells if self.is_complete(c.cell_id)]

    def _atomic_write(self, path: Path, text: str) -> None:
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(text)
        os.replace(tmp, path)


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------
# Datasets rebuilt per cell would dominate tiny-cell sweeps; identical data
# sections (same partitioner, options and derived seed) share one build.
# Bounded so a long alpha × seed campaign cannot hoard partitions.
_DATASET_CACHE: dict[str, object] = {}
_DATASET_CACHE_CAP = 4


def _cell_dataset(spec: ExperimentSpec):
    from repro_torch.fl.experiment import build_dataset

    key = json.dumps(spec.data.to_dict(), sort_keys=True)
    if key not in _DATASET_CACHE:
        if len(_DATASET_CACHE) >= _DATASET_CACHE_CAP:
            _DATASET_CACHE.pop(next(iter(_DATASET_CACHE)))
        _DATASET_CACHE[key] = build_dataset(spec.data)
    return _DATASET_CACHE[key]


def run_cell(store: RunStore, cell: SweepCell, *, device="cuda") -> dict:
    """Run one cell to completion on ``device``: stream records to JSONL,
    then finalize.

    Opens the records file in truncate mode so a rerun after a mid-cell
    kill never leaves stale lines behind; the summary marker lands last
    (atomically), so completeness implies a full, consistent record file.
    """
    from repro_torch.fl.experiment import build_experiment

    ds = _cell_dataset(cell.spec)
    with open(store.records_path(cell.cell_id), "w") as fh:
        with build_experiment(cell.spec, dataset=ds, device=device) as srv:
            hist = srv.run(on_round=lambda rec: store.append_record(fh, rec))
    summary = summarize_history(hist, cell.spec.train.n_rounds)
    store.finalize_cell(cell.cell_id, summary)
    return summary


def _pool_run_cell(
    store_root: str, spec_dict: dict, cell_id: str, device: str
) -> tuple[str, dict, float]:
    """Process-pool entry point (must be top-level picklable)."""
    store = RunStore(store_root)
    cell = SweepCell(
        cell_id=cell_id, grid_index=-1, seed_index=-1, overrides={},
        spec=ExperimentSpec.from_dict(spec_dict),
    )
    t0 = time.perf_counter()
    summary = run_cell(store, cell, device=device)
    return cell_id, summary, time.perf_counter() - t0


def run_sweep(
    sweep: Union[SweepSpec, dict],
    store_dir: Union[str, Path],
    *,
    workers: int = 1,
    on_cell: Optional[Callable[[SweepCell, str, Optional[dict], float], None]] = None,
    device="cuda",
) -> RunStore:
    """Run (or resume) a whole campaign into ``store_dir`` on ``device``.

    Completed cells are skipped, so re-invoking after a kill finishes only
    the remainder and the store's collated output is bit-identical to an
    uninterrupted run. ``workers > 1`` fans independent cells out over a
    spawn-based process pool (each worker writes its own cell files; the
    parent finalization order doesn't matter because cell files are
    disjoint). ``on_cell(cell, status, summary, seconds)`` streams progress
    with ``status`` in ``{"ran", "skipped"}``. Each pool worker runs its
    cells on ``device`` too.
    """
    sweep = SweepSpec.from_dict(sweep) if isinstance(sweep, dict) else sweep
    store = RunStore(store_dir)
    store.write_manifest(sweep)
    cells = sweep.cells()
    todo = []
    for cell in cells:
        if store.is_complete(cell.cell_id):
            if on_cell is not None:
                on_cell(cell, "skipped", store.read_summary(cell.cell_id), 0.0)
        else:
            todo.append(cell)
    if not todo:
        return store
    if workers <= 1:
        for cell in todo:
            t0 = time.perf_counter()
            summary = run_cell(store, cell, device=device)
            if on_cell is not None:
                on_cell(cell, "ran", summary, time.perf_counter() - t0)
        return store

    import concurrent.futures as cf
    import multiprocessing as mp

    by_id = {c.cell_id: c for c in todo}
    # spawn (not fork): a forked child cannot use CUDA, and the parent may
    # hold planner threads. Children import repro_torch by module path, so
    # the source tree must be on their PYTHONPATH even when the parent only
    # added it to sys.path.
    src_root = str(Path(__file__).resolve().parents[2])
    old_pp = os.environ.get("PYTHONPATH")
    if src_root not in (old_pp or "").split(os.pathsep):
        os.environ["PYTHONPATH"] = src_root + (os.pathsep + old_pp if old_pp else "")
    try:
        with cf.ProcessPoolExecutor(
            max_workers=workers, mp_context=mp.get_context("spawn")
        ) as pool:
            futs = [
                pool.submit(
                    _pool_run_cell, str(store.root), c.spec.to_dict(), c.cell_id, str(device)
                )
                for c in todo
            ]
            for fut in cf.as_completed(futs):
                cell_id, summary, dt = fut.result()
                if on_cell is not None:
                    on_cell(by_id[cell_id], "ran", summary, dt)
    finally:
        if old_pp is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_pp
    return store


# --------------------------------------------------------------------------
# collation
# --------------------------------------------------------------------------
def collate(store: RunStore) -> tuple[list[dict], list[dict]]:
    """Aggregate a completed sweep into tidy rows.

    Returns ``(cell_rows, agg_rows)``: one row per cell (axis columns +
    the :data:`SUMMARY_STATS`), and one row per grid point with mean±std
    over the seed axis (population std, ``ddof=0`` — the replicates *are*
    the population the figure plots). Floats pass through ``repr``-exact
    (stored summary → row), so resumed and uninterrupted runs collate to
    identical bytes.
    """
    sweep = store.read_manifest()
    cells = sweep.cells()
    missing = [c.cell_id for c in cells if not store.is_complete(c.cell_id)]
    if missing:
        raise ValueError(
            f"cannot collate: {len(missing)}/{len(cells)} cells incomplete "
            f"(first missing: {missing[0]}); re-invoke run_sweep on this store"
        )
    axis_cols = list(sweep.axes)
    cell_rows = []
    for c in cells:
        row = {"cell": c.cell_id, "grid": c.grid_index, "seed": c.seed_index}
        for path in axis_cols:
            row[path] = override_label(path, c.overrides[path])
        row.update(store.read_summary(c.cell_id))
        cell_rows.append(row)

    agg_rows = []
    n_grid = len(sweep._grid())
    for gi in range(n_grid):
        group = [r for r in cell_rows if r["grid"] == gi]
        row = {"grid": gi}
        for path in axis_cols:
            row[path] = group[0][path]
        row["n_seeds"] = len(group)
        for stat in SUMMARY_STATS:
            vals = np.array([r[stat] for r in group], dtype=np.float64)
            row[f"{stat}_mean"] = float(vals.mean())
            row[f"{stat}_std"] = float(vals.std())
        agg_rows.append(row)
    return cell_rows, agg_rows


def write_collated(
    store: RunStore, rows: "tuple[list[dict], list[dict]] | None" = None
) -> tuple[Path, Path]:
    """Write ``cells.csv`` + ``summary.csv`` into the store; return paths.

    ``rows`` short-circuits the :func:`collate` call for callers that
    already hold its result.
    """
    cell_rows, agg_rows = collate(store) if rows is None else rows
    cells_csv = store.root / "cells.csv"
    summary_csv = store.root / "summary.csv"
    _write_csv(cells_csv, cell_rows)
    _write_csv(summary_csv, agg_rows)
    return cells_csv, summary_csv


def _write_csv(path: Path, rows: list[dict]) -> None:
    import csv

    with open(path, "w", newline="") as fh:
        if not rows:
            return
        w = csv.DictWriter(fh, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        for row in rows:
            w.writerow({k: repr(v) if isinstance(v, float) else v for k, v in row.items()})


__all__ = [
    "SEED_PATHS",
    "SUMMARY_STATS",
    "SweepCell",
    "SweepSpec",
    "RunStore",
    "cell_hash",
    "cell_group_label",
    "override_label",
    "set_by_path",
    "summarize_history",
    "degraded_fraction",
    "availability_weighted_time_to_acc",
    "run_cell",
    "run_sweep",
    "collate",
    "write_collated",
]
