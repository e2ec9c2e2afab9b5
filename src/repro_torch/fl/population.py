# Copied from src/repro/fl/population.py.
"""Client-population processes: who can participate in each round.

The paper assumes a fixed population of ``n`` clients that all answer every
round. Production FL does not: clients arrive, vanish mid-round, and report
late. This module models that as a *population process* layered on top of
the static :class:`repro_torch.core.types.ClientPopulation` (which stays the
source of the ``n_i`` sample counts): per round ``t`` the process yields

* an **availability mask** — which of the ``n`` registered clients can be
  drawn at all this round (the sampler conditions its draw on it, see
  ``ClientSampler.sample(t, available=...)``), and
* a **dropout mask** over the round's realized participants — which of them
  vanish *mid-round* (crash, network loss) or exceed the straggler timeout.
  A dropped client becomes a zero-weight slot in the engine's padded slot
  axis and its eq. 3/4 mass falls back on the current global model.

Determinism contract: every mask is a pure function of ``(seed, t)`` —
processes derive a fresh per-round generator from
``np.random.SeedSequence((seed, tag, t))`` and state-carrying processes
(the Poisson churn chain) replay deterministically from round 0 through an
internal cache. A killed server therefore resumes mid-campaign with the
*identical* availability/dropout realizations without the process ever
appearing in the checkpoint.

Scenario generators are registry entries (:data:`POPULATIONS` /
:func:`register_population`) so ``PopulationSpec`` sections on
:class:`~repro_torch.fl.experiment.ExperimentSpec` — and therefore
:class:`~repro_torch.fl.sweep.SweepSpec` axes — reach them by name:

* ``static``   — everyone always available (optional drop/straggle rates),
* ``poisson``  — discretized Poisson arrival/departure: each client is an
  on/off Markov chain with per-round join/leave probabilities,
* ``periodic`` — diurnal-style availability windows (period/duty/phase),
* ``dropout``  — full availability, Bernoulli mid-round dropout + straggler
  timeout (the classic "x% of participants fail" stress model).
"""
from __future__ import annotations

import abc

import numpy as np

from repro_torch.core.registry import Registry

# SeedSequence stream tags: availability, dropout and static phase draws
# come from disjoint streams, so changing one scenario knob never shifts
# the others.
_AVAIL_TAG = 0x41
_DROP_TAG = 0x44
_PHASE_TAG = 0x50


def _round_rng(seed: int, tag: int, t: int) -> np.random.Generator:
    """The (seed, tag, t)-keyed generator behind the determinism contract."""
    return np.random.default_rng(np.random.SeedSequence((int(seed), tag, int(t))))


class PopulationProcess(abc.ABC):
    """Round-indexed availability + mid-round dropout over ``n_clients``.

    Subclasses implement :meth:`_availability` only; the Bernoulli mid-round
    dropout and straggler-timeout machinery is shared (every scenario can be
    combined with them). ``drop_rate`` is the per-participant probability of
    vanishing mid-round; ``straggle_rate`` the probability of exceeding the
    round deadline — both resolve to the same fate (a zero-weight slot) but
    are drawn from one stream in that order, so the split is reproducible.
    """

    def __init__(
        self,
        n_clients: int,
        *,
        seed: int = 0,
        drop_rate: float = 0.0,
        straggle_rate: float = 0.0,
    ):
        if n_clients <= 0:
            raise ValueError("n_clients must be positive")
        for name, rate in (("drop_rate", drop_rate), ("straggle_rate", straggle_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.n_clients = int(n_clients)
        self.seed = int(seed)
        self.drop_rate = float(drop_rate)
        self.straggle_rate = float(straggle_rate)

    # -- availability --------------------------------------------------------
    @abc.abstractmethod
    def _availability(self, t: int) -> np.ndarray:
        """Boolean (n,) mask of clients able to participate in round ``t``."""

    def available_mask(self, t: int) -> np.ndarray:
        """The round-``t`` availability mask (deterministic in (seed, t))."""
        mask = np.asarray(self._availability(int(t)), dtype=bool)
        if mask.shape != (self.n_clients,):
            raise ValueError(
                f"{type(self).__name__} produced mask shape {mask.shape}, "
                f"expected ({self.n_clients},)"
            )
        return mask

    # -- mid-round dropout ---------------------------------------------------
    def dropout_mask(self, t: int, client_ids: np.ndarray) -> np.ndarray:
        """True where the realized participant vanishes mid-round.

        ``client_ids`` are the round's *distinct* participants; the draw is
        keyed by (seed, t) and indexed by client id, so the same client has
        the same fate regardless of who else was drawn that round.
        """
        ids = np.asarray(client_ids, dtype=np.int64)
        if self.drop_rate == 0.0 and self.straggle_rate == 0.0:
            return np.zeros(ids.shape, dtype=bool)
        rng = _round_rng(self.seed, _DROP_TAG, t)
        # one (n,) draw per failure mode, indexed by id: per-client fate is
        # independent of the sampled set (a real device crashes on its own)
        crash = rng.random(self.n_clients) < self.drop_rate
        straggle = rng.random(self.n_clients) < self.straggle_rate
        return (crash | straggle)[ids]


class StaticPopulation(PopulationProcess):
    """The paper's fixed population: everyone is available every round."""

    def _availability(self, t: int) -> np.ndarray:
        del t
        return np.ones(self.n_clients, dtype=bool)


class BernoulliDropoutPopulation(StaticPopulation):
    """Full availability, Bernoulli mid-round dropout / straggler timeout.

    ``rate`` aliases ``drop_rate`` to keep the spec surface obvious:
    ``{"name": "dropout", "options": {"rate": 0.2}}``.
    """

    def __init__(
        self,
        n_clients: int,
        *,
        seed: int = 0,
        rate: float = 0.1,
        straggle_rate: float = 0.0,
    ):
        super().__init__(
            n_clients, seed=seed, drop_rate=rate, straggle_rate=straggle_rate
        )


class PoissonChurnPopulation(PopulationProcess):
    """Discretized Poisson arrival/departure churn.

    Each client is an independent on/off Markov chain: an offline client
    comes online with probability ``1 - exp(-join_rate)`` per round, an
    online one leaves with ``1 - exp(-leave_rate)``. The chain starts all-on
    (the paper's state) and is replayed deterministically from round 0, so a
    resumed server sees the identical availability trajectory; the replay is
    cached, so a service running forward pays O(n) per new round.

    ``min_available`` floors the online count — when a step would drop below
    it, the lowest-indexed clients that were online keep their session. A
    fleet where *everyone* left has nothing to train on (the server would
    raise ``EmptyRoundError``), so the floor defaults to 1.
    """

    def __init__(
        self,
        n_clients: int,
        *,
        seed: int = 0,
        join_rate: float = 0.5,
        leave_rate: float = 0.1,
        min_available: int = 1,
        drop_rate: float = 0.0,
        straggle_rate: float = 0.0,
    ):
        super().__init__(
            n_clients, seed=seed, drop_rate=drop_rate, straggle_rate=straggle_rate
        )
        if join_rate < 0 or leave_rate < 0:
            raise ValueError("join_rate / leave_rate must be >= 0")
        if not 0 <= min_available <= n_clients:
            raise ValueError(
                f"min_available must be in [0, {n_clients}], got {min_available}"
            )
        self.p_join = 1.0 - float(np.exp(-join_rate))
        self.p_leave = 1.0 - float(np.exp(-leave_rate))
        self.min_available = int(min_available)
        self._chain: list[np.ndarray] = [np.ones(self.n_clients, dtype=bool)]

    def _availability(self, t: int) -> np.ndarray:
        while len(self._chain) <= t:
            s = len(self._chain)
            prev = self._chain[-1]
            rng = _round_rng(self.seed, _AVAIL_TAG, s)
            join = rng.random(self.n_clients) < self.p_join
            leave = rng.random(self.n_clients) < self.p_leave
            cur = np.where(prev, ~leave, join)
            short = self.min_available - int(cur.sum())
            if short > 0:
                # keep the lowest-indexed previously-online clients connected
                stay = np.flatnonzero(prev & ~cur)[:short]
                cur = cur.copy()
                cur[stay] = True
            self._chain.append(cur)
        return self._chain[t]


class PeriodicAvailabilityPopulation(PopulationProcess):
    """Diurnal-style availability windows.

    Client ``i`` is online while ``(t + phase_i) mod period < duty·period``.
    Phases are staggered evenly by default (``stagger=True``) so some slice
    of the fleet is always on; ``stagger=False`` draws random phases from
    the process seed instead (synchronized outages become possible —
    ``min_available`` floors the online count the same way the churn chain
    does).
    """

    def __init__(
        self,
        n_clients: int,
        *,
        seed: int = 0,
        period: int = 10,
        duty: float = 0.5,
        stagger: bool = True,
        min_available: int = 1,
        drop_rate: float = 0.0,
        straggle_rate: float = 0.0,
    ):
        super().__init__(
            n_clients, seed=seed, drop_rate=drop_rate, straggle_rate=straggle_rate
        )
        if period < 1:
            raise ValueError(f"period must be >= 1, got {period}")
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {duty}")
        self.period = int(period)
        self.duty = float(duty)
        self.window = max(1, int(np.ceil(duty * period)))
        self.min_available = int(min_available)
        if stagger:
            self._phase = (np.arange(self.n_clients) * self.period) // max(
                self.n_clients, 1
            )
        else:
            self._phase = _round_rng(self.seed, _PHASE_TAG, 0).integers(
                0, self.period, size=self.n_clients
            )

    def _availability(self, t: int) -> np.ndarray:
        mask = ((t + self._phase) % self.period) < self.window
        short = self.min_available - int(mask.sum())
        if short > 0:
            forced = (t + np.arange(short)) % self.n_clients
            mask = mask.copy()
            mask[forced] = True
        return mask


#: name -> factory(n_clients, seed=..., **options) returning a
#: PopulationProcess; PopulationSpec sections resolve through this.
POPULATIONS = Registry(
    "population",
    {
        "static": StaticPopulation,
        "poisson": PoissonChurnPopulation,
        "periodic": PeriodicAvailabilityPopulation,
        "dropout": BernoulliDropoutPopulation,
    },
)

register_population = POPULATIONS.register


def build_population(spec, n_clients: int) -> PopulationProcess:
    """Resolve a :class:`~repro_torch.fl.experiment.PopulationSpec` (or its dict
    form) through :data:`POPULATIONS` and construct the process."""
    import inspect

    from repro_torch.fl.experiment import PopulationSpec

    spec = PopulationSpec.from_dict(spec) if isinstance(spec, dict) else spec
    factory = POPULATIONS.get(spec.name)
    accepted = set(inspect.signature(factory).parameters) - {"self", "n_clients", "seed"}
    unknown = set(spec.options) - accepted
    if unknown:
        raise ValueError(
            f"population {spec.name!r} does not accept option(s) {sorted(unknown)}; "
            f"accepted options: {sorted(accepted)}"
        )
    return factory(n_clients, seed=spec.seed, **spec.options)


__all__ = [
    "PopulationProcess",
    "StaticPopulation",
    "BernoulliDropoutPopulation",
    "PoissonChurnPopulation",
    "PeriodicAvailabilityPopulation",
    "POPULATIONS",
    "register_population",
    "build_population",
]
