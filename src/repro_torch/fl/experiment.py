# Adapted from src/repro/fl/experiment.py: the same spec sections, key for
# key; the build_* functions take a device.
"""Declarative experiment API: one spec dict → a runnable FL experiment.

An :class:`ExperimentSpec` names everything a run needs — the dataset
partition, the client-selection scheme, the plan rebuild cadence, the round
engine, the train hyperparameters, and the client-churn scenario — as a
JSON-round-trippable dict of seven sections::

    {
      "data":       {"name": "by_class_shards", "options": {"dim": 32}},
      "sampler":    {"name": "algorithm2", "m": 10},
      "planner":    {"mode": "async", "rebuild_every": 2},
      "engine":     {"name": "batched"},
      "train":      {"n_rounds": 25, "lr": 0.05},
      "population": {"name": "static"},
      "scheduler":  {"name": "sync"}
    }

``build_experiment(spec, device=...)`` resolves every name through a
registry (``repro_torch.core.samplers.SAMPLERS``,
``repro_torch.fl.engine.ENGINES``, :data:`DATASETS`) and returns a
lifecycle-safe :class:`~repro_torch.fl.server.FederatedServer` — use it as
a context manager so async planner workers are always released::

    with build_experiment(spec, device="cuda") as srv:
        history = srv.run(on_round=print)   # streaming per-round telemetry

Every section's ``to_dict`` equals the reference's key for key, so one
spec dict names one sweep cell (``repro_torch.fl.sweep.cell_hash``) in both
packages. The device is a runtime argument of the builders, never a spec
key: a spec that named a device would hash to another cell.

Every section builds: an ``engine.mesh_spec`` splits the batched engine's
client axis and the scheme's gradient store over a device mesh
(:mod:`repro_torch.launch.mesh`) whose lead device is ``device``; every
``population`` and ``scheduler`` section and ``train.checkpoint_every``.

Everything model-sized stays inferred: ``update_dim`` (the flattened MLP
size Algorithm 2's gradient store needs) and the class count come from the
built model/dataset, so specs carry intent only.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.core.registry import Registry
from repro_torch.core.samplers import SAMPLERS
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.partition import by_class_shards, dirichlet_labels
from repro_torch.fl.server import FederatedServer, FLConfig

#: name -> dataset factory returning a FederatedDataset; the seed entries
#: are the paper's two partitioners. register_dataset plugs in new ones.
DATASETS = Registry(
    "dataset",
    {
        "by_class_shards": by_class_shards,
        "dirichlet_labels": dirichlet_labels,
    },
)

register_dataset = DATASETS.register


# --------------------------------------------------------------------------
# spec dataclasses (frozen, dict-round-trippable)
# --------------------------------------------------------------------------
def _from_dict(cls, d: dict, nested: dict = {}):
    """Shared ``from_dict``: precise unknown-key errors + nested spec parse."""
    if not isinstance(d, dict):
        raise ValueError(f"{cls.__name__}.from_dict expects a dict, got {type(d).__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(
            f"{cls.__name__}.from_dict: unknown key(s) {sorted(unknown)}; "
            f"accepted keys: {sorted(fields)}"
        )
    required = {
        f.name
        for f in dataclasses.fields(cls)
        if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING
    }
    missing = required - set(d)
    if missing:
        raise ValueError(
            f"{cls.__name__}.from_dict: missing required key(s) {sorted(missing)}"
        )
    kw = dict(d)
    for key, sub in nested.items():
        if key in kw and not isinstance(kw[key], sub):
            kw[key] = sub.from_dict(kw[key])
    return cls(**kw)


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Which federated partition to build (a :data:`DATASETS` name)."""

    name: str
    options: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "DataSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return {"name": self.name, "options": dict(self.options)}


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Which client-selection scheme to run (a ``SAMPLERS`` name).

    ``options`` passes scheme-specific knobs through (``measure``,
    ``distance_fn``, ``staleness_decay``, ``groups`` …) — keys are checked
    against the scheme's signature at build time. ``update_dim`` may be set
    here to override the inferred flattened-model size.
    """

    name: str
    m: int
    seed: int = 0
    options: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "SamplerSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return {"name": self.name, "m": self.m, "seed": self.seed, "options": dict(self.options)}


@dataclasses.dataclass(frozen=True)
class PlannerSpec:
    """When — and with what backend — plan-rebuilding samplers re-cluster.

    ``mode="async"`` overlaps Algorithm 2's rebuild with the next round's
    local work; ``rebuild_every=k`` re-clusters only every k observed
    rounds (``RoundRecord.plan_version`` records which observation each
    round's plan incorporates); ``drift_threshold`` replaces the fixed
    cadence with the measured trigger — a rebuild fires only when the
    assignment churn of fresh gradients against the live plan's clusters
    reaches the threshold (``RoundRecord.plan_drift`` records it).
    ``clusterer`` names the grouping backend from
    :data:`repro_torch.core.clustering.backends.CLUSTERERS` (``"ward"`` — the
    paper-faithful default, ``"ward_jit"``, ``"kmeans"``, or anything
    ``register_clusterer`` added). ``sketch``/``sketch_dim`` attach the
    gradient store's device-side sketch stage (a
    :data:`repro_torch.kernels.sketch.SKETCHERS` name — ``"srp"``,
    ``"countsketch"``, or ``"identity"`` for the exact legacy path; a
    compressing sketch needs ``sketch_dim`` = d′), so the store, the
    similarity stage and the drift monitor all scale in d′ instead of the
    model dimension. Ignored by plan-free samplers only when it is the
    default — asking a planless scheme for an async planner is an error,
    not a silent no-op.
    """

    mode: str = "sync"
    rebuild_every: int = 1
    clusterer: str = "ward"
    drift_threshold: Optional[float] = None
    sketch: Optional[str] = None
    sketch_dim: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(f"unknown planner mode {self.mode!r}; choose sync | async")
        if self.rebuild_every < 1:
            raise ValueError(f"rebuild_every must be >= 1, got {self.rebuild_every}")
        if self.drift_threshold is not None:
            if self.drift_threshold < 0:
                raise ValueError(
                    f"drift_threshold must be >= 0, got {self.drift_threshold}"
                )
            if self.rebuild_every != 1:
                raise ValueError(
                    "drift_threshold and rebuild_every are alternative rebuild "
                    f"schedules; got both (rebuild_every={self.rebuild_every})"
                )
        if self.sketch_dim is not None:
            if self.sketch is None:
                raise ValueError(
                    f"sketch_dim={self.sketch_dim} without a sketch; set "
                    "PlannerSpec.sketch (e.g. 'srp') or drop sketch_dim"
                )
            if self.sketch_dim < 1:
                raise ValueError(f"sketch_dim must be >= 1, got {self.sketch_dim}")

    @property
    def is_default(self) -> bool:
        return (
            self.mode == "sync"
            and self.rebuild_every == 1
            and self.clusterer == "ward"
            and self.drift_threshold is None
            and self.sketch is None
            and self.sketch_dim is None
        )

    @classmethod
    def from_dict(cls, d: dict) -> "PlannerSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "rebuild_every": self.rebuild_every,
            "clusterer": self.clusterer,
            "drift_threshold": self.drift_threshold,
            "sketch": self.sketch,
            "sketch_dim": self.sketch_dim,
        }


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Which round executor runs the local work (an ``ENGINES`` name)."""

    name: str = "batched"
    # None | "auto" | "DxM" | (D, M) — see repro_torch.launch.mesh.resolve_fl_mesh
    mesh_spec: Union[str, tuple, None] = None
    max_staged_bytes: int = 2 << 30

    def __post_init__(self):
        if isinstance(self.mesh_spec, list):
            object.__setattr__(self, "mesh_spec", tuple(self.mesh_spec))

    @classmethod
    def from_dict(cls, d: dict) -> "EngineSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        mesh = self.mesh_spec
        if mesh is not None and not isinstance(mesh, (str, tuple)):
            raise ValueError(
                f"EngineSpec.mesh_spec {mesh!r} is not dict-serializable; "
                "use None, 'auto', a 'DxM' string or a (D, M) shape"
            )
        return {
            "name": self.name,
            "mesh_spec": list(mesh) if isinstance(mesh, tuple) else mesh,
            "max_staged_bytes": self.max_staged_bytes,
        }


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """Which client-churn scenario the service runs under (a
    ``POPULATIONS`` name in the reference).

    The default — ``static`` with no options — is the paper's fixed
    population; ``build_experiment`` then attaches *no* population process
    at all, keeping batch experiments on the exact pre-service code path.
    ``options`` passes scenario knobs through (``join_rate``, ``leave_rate``,
    ``rate``, ``period``, ``duty``, ``drop_rate``, ``straggle_rate``, …),
    checked against the process signature at build time.
    """

    name: str = "static"
    seed: int = 0
    options: dict = dataclasses.field(default_factory=dict)

    @property
    def is_default(self) -> bool:
        return self.name == "static" and not self.options

    @classmethod
    def from_dict(cls, d: dict) -> "PopulationSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed, "options": dict(self.options)}


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """How rounds close and whether availability history is tracked.

    ``name`` is a ``SCHEDULERS`` entry of the reference (``"sync"`` —
    the legacy synchronous round and the default; ``"deadline"`` — straggler
    grading with harvest-into-next-round; ``"overselect"`` — draw
    ``m·(1+β)``, aggregate the first ``m``); ``options`` passes
    scheduler-specific knobs (``deadline``, ``straggle_frac``,
    ``slow_factor``, ``harvest_discount``, ``beta``), checked against the
    scheduler's signature at build time.

    ``track_availability=True`` additionally attaches an
    ``AvailabilityTracker`` (knobs:
    ``avail_decay``/``avail_threshold``/``late_credit``) to the server —
    and to the sampler when it is store-backed, restricting plan rebuilds
    to recently-seen clients. The default spec — sync, no options, no
    tracking — attaches *nothing*: batch experiments stay on the exact
    pre-scheduler code path.
    """

    name: str = "sync"
    seed: int = 0
    options: dict = dataclasses.field(default_factory=dict)
    track_availability: bool = False
    avail_decay: float = 0.9
    avail_threshold: float = 0.25
    late_credit: float = 0.5

    @property
    def is_default(self) -> bool:
        return self.name == "sync" and not self.options and not self.track_availability

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulerSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "options": dict(self.options),
            "track_availability": self.track_availability,
            "avail_decay": self.avail_decay,
            "avail_threshold": self.avail_threshold,
            "late_credit": self.late_credit,
        }


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Round/optimization hyperparameters + the paper's MLP shape.

    ``n_classes=None`` infers the class count from the dataset's labels;
    ``hidden`` are the MLP's hidden widths (the paper's 1×50 by default).
    """

    n_rounds: int = 10
    n_local_steps: int = 10  # N in the paper
    batch_size: int = 50  # B in the paper
    lr: float = 0.05
    momentum: float = 0.0
    fedprox_mu: float = 0.0
    eval_every: int = 1
    seed: int = 0
    hidden: tuple = (50,)
    n_classes: Optional[int] = None
    model_seed: int = 1
    # service cadence: checkpoint the full server state every k completed
    # rounds (0 = batch mode, never checkpoint); the path is a runtime knob
    # of build_experiment, not part of the spec
    checkpoint_every: int = 0

    def __post_init__(self):
        object.__setattr__(self, "hidden", tuple(self.hidden))

    @classmethod
    def from_dict(cls, d: dict) -> "TrainSpec":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["hidden"] = list(self.hidden)
        return out


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The whole experiment as one declarative value."""

    data: DataSpec
    sampler: SamplerSpec
    planner: PlannerSpec = PlannerSpec()
    engine: EngineSpec = EngineSpec()
    train: TrainSpec = TrainSpec()
    population: PopulationSpec = PopulationSpec()
    scheduler: SchedulerSpec = SchedulerSpec()

    _NESTED = {
        "data": DataSpec,
        "sampler": SamplerSpec,
        "planner": PlannerSpec,
        "engine": EngineSpec,
        "train": TrainSpec,
        "population": PopulationSpec,
        "scheduler": SchedulerSpec,
    }

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        return _from_dict(cls, d, nested=cls._NESTED)

    def to_dict(self) -> dict:
        return {name: getattr(self, name).to_dict() for name in self._NESTED}

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_arg(cls, arg: str) -> "ExperimentSpec":
        """Parse a CLI ``--spec`` argument: inline JSON or a JSON file path."""
        return cls.from_dict(load_spec_dict(arg))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def build(self, **kw) -> FederatedServer:
        """Alias for :func:`build_experiment` (``spec.build()``)."""
        return build_experiment(self, **kw)


def load_spec_dict(arg: str) -> dict:
    """Read a CLI spec argument — a path to a JSON file, else inline JSON.

    The one place the path-vs-inline disambiguation lives; both
    ``repro_torch.benchmarks.run --spec`` and the sweep CLI parse through it.
    """
    import os

    raw = open(arg).read() if os.path.exists(arg) else arg
    try:
        d = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"--spec argument is neither an existing file nor valid JSON "
            f"({e}); got: {arg[:120]!r}"
        ) from None
    if not isinstance(d, dict):
        raise ValueError(f"--spec JSON must be an object, got {type(d).__name__}")
    return d


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------
#: constructor arguments that are not spec options: the positional pair
#: every sampler takes, and the runtime device
_NOT_OPTIONS = {"self", "population", "m", "device"}


def _checked_kwargs(kind: str, name: str, factory, options: dict) -> inspect.Signature:
    """Validate ``options`` keys against ``factory``'s signature; return it."""
    sig = inspect.signature(factory)
    params = sig.parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return sig
    accepted = set(params) - _NOT_OPTIONS
    unknown = set(options) - accepted
    if unknown:
        raise ValueError(
            f"{kind} {name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted options: {sorted(accepted)}"
        )
    return sig


def build_dataset(spec: Union[DataSpec, dict]) -> FederatedDataset:
    """Resolve a :class:`DataSpec` through :data:`DATASETS` and build it."""
    spec = DataSpec.from_dict(spec) if isinstance(spec, dict) else spec
    factory = DATASETS.get(spec.name)
    _checked_kwargs("dataset", spec.name, factory, spec.options)
    return factory(**spec.options)


def build_sampler(
    spec: Union[SamplerSpec, dict],
    population,
    *,
    planner: Optional[PlannerSpec] = None,
    update_dim: Optional[int] = None,
    store_mesh_spec=None,
    device="cuda",
):
    """Resolve a :class:`SamplerSpec` through ``SAMPLERS`` and construct it.

    ``planner`` feeds the scheme's plan service (only schemes that take a
    ``planner`` kwarg accept a non-default one); ``update_dim`` is the
    flattened model size handed to similarity-based schemes unless the spec
    pins its own in ``options``. ``store_mesh_spec`` (the engine's mesh, in
    practice) shards the scheme's gradient store over its client axis when
    the scheme has one — silently skipped otherwise, since the mesh is an
    engine knob rather than a sampling-scheme choice. ``device`` holds the
    gradient store of the schemes that have one (Algorithm 2 and the scheme
    zoo); the host-only schemes ignore it.
    """
    spec = SamplerSpec.from_dict(spec) if isinstance(spec, dict) else spec
    cls = SAMPLERS.get(spec.name)
    kwargs = dict(spec.options)
    sig = _checked_kwargs("sampler", spec.name, cls, kwargs)
    params = sig.parameters
    if "groups" in kwargs:  # JSON carries lists; samplers want index arrays
        kwargs["groups"] = [np.asarray(g, dtype=np.int64) for g in kwargs["groups"]]
    if "seed" in params:
        kwargs.setdefault("seed", spec.seed)
    if planner is not None:
        if "planner" in params:
            kwargs.setdefault("planner", planner.mode)
            if "rebuild_every" in params:
                kwargs.setdefault("rebuild_every", planner.rebuild_every)
            if "clusterer" in params:
                kwargs.setdefault("clusterer", planner.clusterer)
            elif planner.clusterer != "ward":
                raise ValueError(
                    f"sampler {spec.name!r} accepts no clusterer; "
                    f"PlannerSpec.clusterer={planner.clusterer!r} would be "
                    "silently ignored"
                )
            if "drift_threshold" in params:
                kwargs.setdefault("drift_threshold", planner.drift_threshold)
            elif planner.drift_threshold is not None:
                raise ValueError(
                    f"sampler {spec.name!r} accepts no drift_threshold; "
                    f"PlannerSpec.drift_threshold={planner.drift_threshold} "
                    "would be silently ignored"
                )
            if "sketch" in params:
                kwargs.setdefault("sketch", planner.sketch)
                if "sketch_dim" in params:
                    kwargs.setdefault("sketch_dim", planner.sketch_dim)
            elif planner.sketch is not None:
                raise ValueError(
                    f"sampler {spec.name!r} has no gradient-store sketch "
                    f"stage; PlannerSpec.sketch={planner.sketch!r} would be "
                    "silently ignored"
                )
        elif not planner.is_default:
            raise ValueError(
                f"sampler {spec.name!r} has no plan service; a non-default "
                f"PlannerSpec ({planner.to_dict()}) would be silently ignored "
                "— drop it or pick a plan-rebuilding sampler"
            )
    if "update_dim" in params and "update_dim" not in kwargs:
        if update_dim is None:
            raise ValueError(
                f"sampler {spec.name!r} needs update_dim (the flattened model "
                "size its gradient store holds); pass update_dim=... to "
                "build_sampler or set it in SamplerSpec.options"
            )
        kwargs["update_dim"] = int(update_dim)
    if store_mesh_spec is not None and "store_mesh_spec" in params:
        kwargs.setdefault("store_mesh_spec", store_mesh_spec)
    if "device" in params:
        kwargs["device"] = device
    return cls(population, spec.m, **kwargs)


def _infer_n_classes(dataset: FederatedDataset) -> int:
    return int(max(int(c.y_train.max()) for c in dataset.clients)) + 1


def build_experiment(
    spec: Union[ExperimentSpec, dict],
    *,
    dataset: Optional[FederatedDataset] = None,
    loss_fn: Optional[Callable] = None,
    acc_fn: Optional[Callable] = None,
    checkpoint_path: Optional[str] = None,
    device="cuda",
) -> FederatedServer:
    """Build the lifecycle-safe server an :class:`ExperimentSpec` describes.

    ``dataset`` short-circuits :func:`build_dataset` so scenario matrices
    sharing one partition build it once. The returned server owns the
    sampler's background resources — run it under ``with`` (or call
    ``close()``) so async planner workers never leak. ``loss_fn``/``acc_fn``
    override the defaults (FedProx is selected automatically when
    ``train.fedprox_mu > 0``). ``checkpoint_path`` is where the service
    cadence (``train.checkpoint_every``) writes server state bundles — a
    runtime knob, deliberately not part of the spec. ``device`` holds the
    model, the staged client data, the gradient store and the scheduler's
    harvest buffer; the default ``"cuda"`` raises without a GPU.

    The MLP's initial parameters come from the port's
    :func:`~repro_torch.models.simple.init_mlp`, seeded with
    ``train.model_seed``; they are not the reference's numbers (its
    ``init_mlp`` draws with jax's threefry).

    A non-default ``population`` section attaches its population process;
    a scheduler section other than plain ``"sync"`` attaches its
    :class:`~repro_torch.fl.scheduler.RoundScheduler`;
    ``scheduler.track_availability`` attaches an
    :class:`~repro_torch.fl.availability.AvailabilityTracker` on ``device``
    to the server and, when the scheme is store-backed, to the sampler.
    """
    from repro_torch.fl.aggregation import flatten_params
    from repro_torch.fl.availability import AvailabilityTracker
    from repro_torch.fl.population import build_population
    from repro_torch.models.simple import accuracy, classification_loss, fedprox_loss, init_mlp
    from repro_torch.optim.sgd import sgd

    spec = ExperimentSpec.from_dict(spec) if isinstance(spec, dict) else spec
    ds = dataset if dataset is not None else build_dataset(spec.data)
    tr = spec.train
    feat_shape = ds.clients[0].x_train.shape[1:]
    if len(feat_shape) != 1:
        raise ValueError(
            f"build_experiment's MLP needs flat (n, d) client features, got "
            f"per-sample shape {feat_shape}; pass a custom server for image data"
        )
    n_classes = tr.n_classes if tr.n_classes is not None else _infer_n_classes(ds)
    params = init_mlp(
        (int(feat_shape[0]), *tr.hidden, n_classes), seed=tr.model_seed, device=device
    )
    update_dim = int(flatten_params(params).shape[0])
    sampler = build_sampler(
        spec.sampler,
        ds.population,
        planner=spec.planner,
        update_dim=update_dim,
        store_mesh_spec=spec.engine.mesh_spec,
        device=device,
    )
    cfg = FLConfig(
        n_rounds=tr.n_rounds,
        n_local_steps=tr.n_local_steps,
        batch_size=tr.batch_size,
        fedprox_mu=tr.fedprox_mu,
        eval_every=tr.eval_every,
        seed=tr.seed,
        engine=spec.engine.name,
        max_staged_bytes=spec.engine.max_staged_bytes,
        mesh_spec=spec.engine.mesh_spec,
        checkpoint_every=tr.checkpoint_every,
        checkpoint_path=checkpoint_path,
    )
    # the default spec attaches no process at all: batch experiments stay on
    # the exact fixed-population code path (n_available=-1 telemetry included)
    pop = (
        None
        if spec.population.is_default
        else build_population(spec.population, ds.population.n_clients)
    )
    # same pattern for the round scheduler / availability tracker: the
    # default sync-untracked spec attaches neither, keeping the exact
    # legacy round path (and checkpoint layout)
    scheduler = availability = None
    sched = spec.scheduler
    if sched.name != "sync" or sched.options:
        from repro_torch.fl.scheduler import build_scheduler

        scheduler = build_scheduler(
            sched, n_clients=ds.population.n_clients, m=spec.sampler.m, device=device
        )
    if sched.track_availability:
        availability = AvailabilityTracker(
            ds.population.n_clients,
            decay=sched.avail_decay,
            threshold=sched.avail_threshold,
            late_credit=sched.late_credit,
            device=device,
        )
        if hasattr(sampler, "attach_availability"):
            sampler.attach_availability(availability)
    lf = loss_fn if loss_fn is not None else (fedprox_loss if tr.fedprox_mu else classification_loss)
    af = acc_fn if acc_fn is not None else accuracy
    return FederatedServer(
        ds, sampler, params, sgd(tr.lr, tr.momentum), cfg, loss_fn=lf, acc_fn=af,
        population=pop, scheduler=scheduler, availability=availability, device=device,
    )


__all__ = [
    "DataSpec",
    "SamplerSpec",
    "PlannerSpec",
    "EngineSpec",
    "TrainSpec",
    "PopulationSpec",
    "SchedulerSpec",
    "ExperimentSpec",
    "DATASETS",
    "register_dataset",
    "load_spec_dict",
    "build_dataset",
    "build_sampler",
    "build_experiment",
]
