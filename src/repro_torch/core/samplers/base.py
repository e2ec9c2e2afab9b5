# Copied from src/repro/core/samplers/base.py.
"""Sampler interface + Proposition-1 validation + availability conditioning.

A sampler consumes the client population (and, for Algorithm 2, the clients'
representative gradients) and produces a :class:`SampleResult` per round.
Plan-based samplers expose their ``SamplingPlan`` so its Proposition-1
conditions can be checked exactly.

Availability conditioning (the continuous-service path): ``sample(t,
available=mask)`` restricts the draw to the currently-available client set.
For plan-based schemes the restriction is :func:`conditional_plan` — each
urn is masked to the available columns and re-normalized, and the urn's
per-draw aggregation weight becomes its share of the total available mass
instead of the unconditional ``1/m``. That importance correction is what
keeps the scheme unbiased *over the available set*: for any plan satisfying
eq. (8),

    E[ω_i | available] = p_i·a_i / Σ_j p_j·a_j

— exactly the re-normalized data ratios (property-tested on the port's
plans in ``tests/test_torch_statistics.py``). Urns whose entire mass is
unavailable draw nothing; realized weights still sum to 1 whenever any
available mass exists.

Samplers are also checkpointable: :meth:`ClientSampler.state_arrays` /
:meth:`~ClientSampler.state_meta` export the rng bit-generator state (plus
plan matrices and the gradient store for the schemes that carry them), and
:meth:`~ClientSampler.load_state` restores them bit-exactly — the sampler
half of ``FederatedServer``'s crash-safe ``ServerState`` bundle.
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np

from repro_torch.core.types import ClientPopulation, SamplingPlan, SampleResult


def conditional_plan(
    plan: SamplingPlan, available: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Condition a sampling plan on an availability mask.

    Returns ``(r_cond, urn_weights)`` where ``r_cond[k]`` is urn ``k``'s
    draw distribution restricted to the available columns (zero rows for
    urns with no available mass) and ``urn_weights[k]`` is the aggregation
    weight one draw from urn ``k`` carries: ``s_k / Σ_j s_j`` with ``s_k``
    the urn's available mass. For a plan satisfying eq. (8) this makes the
    conditional expectation of the realized weights exactly the
    re-normalized importances ``p_i·a_i / Σ_j p_j·a_j`` (with full
    availability it degenerates to ``1/m`` per draw, the unconditional
    scheme). Raises if no urn has any available mass.
    """
    a = np.asarray(available, dtype=bool)
    if a.shape != (plan.n_clients,):
        raise ValueError(
            f"availability mask shape {a.shape} != ({plan.n_clients},)"
        )
    masked = plan.r * a
    s = masked.sum(axis=1)  # available mass per urn
    total = s.sum()
    if not (np.isfinite(total) and total > 0):
        raise ValueError(
            "no sampling-plan mass on the available client set — every urn "
            "is fully masked out; nothing can be drawn"
        )
    r_cond = np.divide(masked, s[:, None], out=np.zeros_like(masked), where=s[:, None] > 0)
    return r_cond, s / total


class ClientSampler(abc.ABC):
    """Base class for all client-selection schemes."""

    #: whether the scheme satisfies Assumption 4 (unbiased aggregation)
    unbiased: bool = True
    #: whether ``observe_updates`` feeds a re-clustering pipeline (so the
    #: server should bother producing representative gradients)
    consumes_updates: bool = False
    #: whether :meth:`sample_overselect`'s urn-cyclic re-weighting is exact
    #: for this scheme — requires the plan rows to *be* the draw
    #: distributions with eq. (8) column sums; schemes that re-weight draws
    #: themselves (``importance``) opt out
    supports_overselect: bool = True

    def __init__(self, population: ClientPopulation, m: int, *, seed: int = 0):
        if m <= 0:
            raise ValueError("m must be positive")
        self.population = population
        self.m = int(m)
        self._rng = np.random.default_rng(seed)

    @abc.abstractmethod
    def sample(
        self, round_idx: int, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        """Draw the clients participating in round ``round_idx``.

        ``available`` is an optional boolean (n,) mask restricting the draw
        to the currently-available client set (``None`` = everyone, the
        paper's fixed-population behaviour, bit-identical to the
        pre-availability code path). Plan-based schemes condition through
        :func:`conditional_plan`; see the module docstring for the
        unbiasedness-over-the-available-set guarantee.
        """

    # Hooks -----------------------------------------------------------------
    def observe_updates(self, client_ids: np.ndarray, updates: np.ndarray) -> None:
        """Feed back the sampled clients' representative gradients.

        ``updates`` is (len(client_ids), d) — the flattened ``θ_i - θ`` per
        sampled client. Only similarity-based samplers use this.
        """
        del client_ids, updates

    @property
    def plan(self) -> Optional[SamplingPlan]:
        """Current ``r_{k,i}`` matrix for plan-based samplers, else None."""
        return None

    def plan_telemetry(self) -> tuple[int, int]:
        """(plan_version, plan_lag_rounds) of the plan the next draw uses.

        Static-plan and plan-free samplers report (0, 0); samplers backed by
        a :class:`repro_torch.fl.planner.PlanService` report the service's active
        version and how many observed rounds it trails by (always 0 for the
        synchronous planner).
        """
        return (0, 0)

    def plan_cost_telemetry(self) -> tuple[float, float]:
        """(plan_build_ms, plan_drift) of the backing plan service.

        Plan-free and static-plan samplers report (-1.0, -1.0);
        PlanService-backed samplers report the wall-clock ms of the most
        recent completed rebuild and the drift statistic measured at the
        most recent observation (-1.0 when the drift trigger is off). Lands
        in ``RoundRecord.plan_build_ms`` / ``plan_drift``.
        """
        return (-1.0, -1.0)

    def close(self) -> None:
        """Release background resources (async planner workers)."""

    # Checkpointable state ---------------------------------------------------
    # The array/meta split mirrors repro_torch.checkpoint's save_checkpoint(tree,
    # extra=...): arrays ride in the .npz pytree, meta in the JSON sidecar.
    def prepare_state(self) -> None:
        """Quiesce background work so the exported state is well-defined.

        Called by the server immediately before :meth:`state_arrays` /
        :meth:`state_meta`; async-planner samplers flush their in-flight
        rebuild here so the checkpoint captures the sync fixed point.
        """

    def state_arrays(self) -> dict:
        """Array-valued state (plan matrices, gradient stores); may be {}."""
        return {}

    def state_meta(self) -> dict:
        """JSON-serializable state: at minimum the rng bit-generator state."""
        return {"rng": self._rng.bit_generator.state}

    def load_state(self, meta: dict, arrays: dict) -> None:
        """Restore what :meth:`state_arrays`/:meth:`state_meta` exported.

        Bit-exact: after loading, the sampler's future draws equal those of
        the instance that was checkpointed.
        """
        del arrays
        self._rng.bit_generator.state = meta["rng"]

    # Shared machinery -------------------------------------------------------
    def _draw_from_plan(
        self, plan: SamplingPlan, available: Optional[np.ndarray] = None
    ) -> SampleResult:
        """Sample l_k ~ W_k independently (the clustered-sampling draw).

        One vectorized inverse-CDF draw over the (m, n) row-cumsum instead of
        m ``rng.choice`` calls. The arithmetic mirrors ``Generator.choice``
        exactly (per-row cumsum, normalize by the last entry, insertion index
        with ties to the right) and ``rng.random(m)`` consumes the identical
        uniform stream, so the draws are bit-for-bit those of the old loop.

        ``available`` conditions the draw on an availability mask (see
        :func:`conditional_plan`): masked urns re-normalize over their
        available columns and carry their share of the available mass as the
        per-draw aggregation weight; urns with no available mass draw
        nothing (still consuming their uniform, so the stream stays aligned
        across scenarios). An all-true mask takes the unconditional path —
        bit-identical to ``available=None``.
        """
        n = self.population.n_clients
        if available is not None:
            a = np.asarray(available, dtype=bool)
            if a.shape != (n,):
                raise ValueError(f"availability mask shape {a.shape} != ({n},)")
            if a.all():
                available = None
        if available is None:
            cdf = np.cumsum(plan.r, axis=1)
            total = cdf[:, -1]
            # rng.choice validated p per call — keep failing fast on
            # degenerate rows (NaN-poisoned gradients, zero-mass urns)
            # instead of silently collapsing every such draw onto client 0
            bad = ~(np.isfinite(total) & (total > 0))
            if bad.any():
                k = int(np.argmax(bad))
                raise ValueError(
                    f"plan row {k} is not a probability distribution "
                    f"(total mass {total[k]!r}); cannot draw from it"
                )
            cdf /= total[:, None]
            u = self._rng.random(plan.m)
            # searchsorted(side="right") per row: #{i: cdf[k,i] <= u_k};
            # u < 1 and cdf[k,-1] == 1 exactly, so the index never reaches
            # n. A zero-mass client repeats its predecessor's cdf value and
            # can never be hit.
            clients = (cdf <= u[:, None]).sum(axis=1).astype(np.int64)
            counts = np.bincount(clients, minlength=n)
            return SampleResult(clients=clients, agg_weights=counts / plan.m)

        # availability-conditioned draw
        masked = plan.r * a
        s = masked.sum(axis=1)  # available mass per urn
        total = float(s.sum())
        if not np.isfinite(total):
            raise ValueError("plan mass on the available set is not finite")
        u = self._rng.random(plan.m)
        agg = np.zeros(n)
        if total <= 0:
            # every urn fully masked out: nothing to draw — the caller
            # (FederatedServer) turns this into EmptyRoundError
            return SampleResult(clients=np.empty(0, np.int64), agg_weights=agg)
        active = s > 0
        cdf = np.cumsum(masked[active], axis=1)
        cdf /= cdf[:, -1][:, None]
        clients = (cdf <= u[active, None]).sum(axis=1).astype(np.int64)
        # importance-corrected urn weights: urn k's draw carries s_k / Σ s_j
        # so E[ω_i | available] is exactly the re-normalized importances
        np.add.at(agg, clients, s[active] / total)
        return SampleResult(clients=clients, agg_weights=agg)


    # -- overselection -------------------------------------------------------
    def sample_overselect(
        self,
        round_idx: int,
        n_draws: int,
        available: Optional[np.ndarray] = None,
    ) -> SampleResult:
        """Draw ``n_draws > m`` weighted draws from the current plan.

        The overselection scheduler's draw primitive: urns are re-used
        cyclically (draw ``j`` comes from urn ``j mod m``) and each draw
        from urn ``k`` carries ``w_k / c_k`` — ``w_k`` the urn's draw
        weight (``1/m``; its share of available mass when conditioned) and
        ``c_k`` how many of the ``n_draws`` use urn ``k`` — so summed over
        all draws ``E[ω_i] = p_i`` exactly for any eq. (8) plan (and the
        re-normalized ``p_i·a_i / Σ_j p_j·a_j`` under a mask). The result's
        ``draw_weights`` carries the per-draw weights the scheduler thins.

        Only meaningful for plan-based schemes whose rows are the actual
        draw distributions (``supports_overselect``); plan-free samplers
        raise.
        """
        del round_idx
        if not self.supports_overselect:
            raise NotImplementedError(
                f"{type(self).__name__} re-weights its draws itself; the "
                "urn-cyclic overselection re-weighting would not be unbiased "
                "for it — pick a plan-based scheme for scheduler='overselect'"
            )
        plan = self.plan
        if plan is None:
            raise NotImplementedError(
                f"{type(self).__name__} holds no sampling plan; "
                "scheduler='overselect' needs a plan-based scheme"
            )
        return self._draw_from_plan_overselect(plan, n_draws, available)

    def _draw_from_plan_overselect(
        self,
        plan: SamplingPlan,
        n_draws: int,
        available: Optional[np.ndarray] = None,
    ) -> SampleResult:
        """The cyclic-urn weighted draw behind :meth:`sample_overselect`.

        Mirrors :meth:`_draw_from_plan`'s vectorized inverse-CDF arithmetic
        (per-row cumsum, ties right, one uniform per draw) over the urn
        sequence ``0..m-1, 0..`` of length ``n_draws``. Conditioning
        follows :func:`conditional_plan`: masked urns re-normalize over
        their available columns, urns with no available mass consume their
        uniforms but draw nothing, and per-draw weights use the urn's share
        of the total available mass.
        """
        if n_draws < plan.m:
            raise ValueError(
                f"n_draws={n_draws} < m={plan.m}: overselection must cover "
                "every urn at least once"
            )
        n = self.population.n_clients
        urn_of_draw = np.arange(int(n_draws), dtype=np.int64) % plan.m
        c = np.bincount(urn_of_draw, minlength=plan.m).astype(np.float64)
        if available is not None:
            a = np.asarray(available, dtype=bool)
            if a.shape != (n,):
                raise ValueError(f"availability mask shape {a.shape} != ({n},)")
            if a.all():
                available = None
        if available is None:
            cdf = np.cumsum(plan.r, axis=1)
            total = cdf[:, -1]
            bad = ~(np.isfinite(total) & (total > 0))
            if bad.any():
                k = int(np.argmax(bad))
                raise ValueError(
                    f"plan row {k} is not a probability distribution "
                    f"(total mass {total[k]!r}); cannot draw from it"
                )
            cdf /= total[:, None]
            u = self._rng.random(int(n_draws))
            clients = (cdf[urn_of_draw] <= u[:, None]).sum(axis=1).astype(np.int64)
            w = (1.0 / plan.m) / c[urn_of_draw]
            agg = np.zeros(n)
            np.add.at(agg, clients, w)
            return SampleResult(
                clients=clients, agg_weights=agg, draw_weights=w
            )

        masked = plan.r * a
        s = masked.sum(axis=1)
        total = float(s.sum())
        if not np.isfinite(total):
            raise ValueError("plan mass on the available set is not finite")
        u = self._rng.random(int(n_draws))
        agg = np.zeros(n)
        if total <= 0:
            return SampleResult(
                clients=np.empty(0, np.int64),
                agg_weights=agg,
                draw_weights=np.empty(0, np.float64),
            )
        live = s[urn_of_draw] > 0  # draws whose urn has available mass
        cdf = np.cumsum(masked, axis=1)
        cdf = np.divide(
            cdf, s[:, None], out=np.zeros_like(cdf), where=s[:, None] > 0
        )
        rows = urn_of_draw[live]
        clients = (cdf[rows] <= u[live, None]).sum(axis=1).astype(np.int64)
        w = (s[rows] / total) / c[rows]
        np.add.at(agg, clients, w)
        return SampleResult(clients=clients, agg_weights=agg, draw_weights=w)


def validate_plan(
    plan: SamplingPlan, population: ClientPopulation, *, atol: float = 1e-9
) -> None:
    """Assert the two Proposition-1 conditions on an ``r`` matrix.

    * eq. (7): every row of ``r`` is a probability distribution,
    * eq. (8): every column sums to ``m * p_i`` (unbiasedness).

    Raises ``ValueError`` with a precise diagnostic on violation. When the
    plan carries its integer token allocation the check is exact.
    """
    r = plan.r
    m, n = r.shape
    if n != population.n_clients:
        raise ValueError(f"plan covers {n} clients, population has {population.n_clients}")
    if (r < -atol).any():
        bad = np.argwhere(r < -atol)[0]
        raise ValueError(f"negative probability r[{bad[0]},{bad[1]}] = {r[tuple(bad)]}")
    row_sums = r.sum(axis=1)
    if not np.allclose(row_sums, 1.0, atol=atol):
        k = int(np.argmax(np.abs(row_sums - 1.0)))
        raise ValueError(f"eq.(7) violated: sum_i r[{k},i] = {row_sums[k]!r} != 1")
    col_sums = r.sum(axis=0)
    target = plan.m * population.importances
    if not np.allclose(col_sums, target, atol=atol):
        i = int(np.argmax(np.abs(col_sums - target)))
        raise ValueError(
            f"eq.(8) violated: sum_k r[k,{i}] = {col_sums[i]!r} != m*p_i = {target[i]!r}"
        )
    if plan.r_tokens is not None:
        tok = np.asarray(plan.r_tokens, dtype=np.int64)
        M = population.total_samples
        if (tok.sum(axis=1) != M).any():
            raise ValueError("integer allocation: some urn does not hold exactly M tokens")
        expect = plan.m * population.n_samples
        if (tok.sum(axis=0) != expect).any():
            i = int(np.argmax(tok.sum(axis=0) != expect))
            raise ValueError(
                f"integer allocation: client {i} allocated {tok.sum(axis=0)[i]} "
                f"tokens, expected m*n_i = {expect[i]}"
            )


def max_draws_bound(plan: SamplingPlan) -> np.ndarray:
    """Upper bound on how many times each client can be drawn = #{k: r_{k,i} > 0}.

    For Algorithm 1 this is at most ``floor(m p_i) + 2`` (Section 4 of the
    paper), versus ``m`` for MD sampling.
    """
    return (plan.r > 0).sum(axis=0)
