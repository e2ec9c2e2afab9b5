"""The port's population processes and the server's availability and drop
phases against the JAX package's: the same masks, the same rounds."""
import numpy as np
import pytest

from repro.fl import FederatedServer as RefServer
from repro.fl import FLConfig as RefConfig
from repro.fl import by_class_shards as ref_by_class_shards
from repro.fl.population import POPULATIONS as REF_POPULATIONS
from repro.fl.population import PopulationProcess as RefProcess
from repro.fl.population import build_population as ref_build_population
from repro.core import MDSampler as RefMD
from repro.models.simple import init_mlp as ref_init_mlp
from repro.optim import sgd as ref_sgd
from repro_torch.core import MDSampler
from repro_torch.core.samplers.base import ClientSampler
from repro_torch.core.types import SampleResult
from repro_torch.fl.partition import by_class_shards
from repro_torch.fl.population import POPULATIONS, PopulationProcess, build_population
from repro_torch.fl.server import EmptyRoundError, FederatedServer, FLConfig
from repro_torch.models.simple import params_from_numpy
from repro_torch.optim.sgd import sgd
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

N = 40
SECTIONS = {
    "static": {"name": "static"},
    "static+drops": {"name": "static", "seed": 3, "options": {"drop_rate": 0.2, "straggle_rate": 0.1}},
    "dropout": {"name": "dropout", "seed": 1, "options": {"rate": 0.3}},
    "poisson": {"name": "poisson", "seed": 2, "options": {"join_rate": 0.3, "leave_rate": 0.4}},
    "poisson+floor": {"name": "poisson", "options": {"leave_rate": 3.0, "min_available": 5,
                                                      "drop_rate": 0.1}},
    "periodic": {"name": "periodic", "seed": 4, "options": {"period": 5, "duty": 0.4}},
    "periodic+random": {"name": "periodic", "seed": 4,
                        "options": {"period": 7, "duty": 0.2, "stagger": False, "min_available": 3}},
}


def test_registry_equals_reference():
    assert POPULATIONS.names() == REF_POPULATIONS.names()


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_masks_equal_reference_per_round(section):
    """Availability and dropout masks of 20 rounds, queried out of order."""
    ref = ref_build_population(SECTIONS[section], N)
    port = build_population(SECTIONS[section], N)
    ids = np.random.default_rng(0).choice(N, size=12, replace=False)
    for t in (7, 0, 19, 3, *range(20)):
        np.testing.assert_array_equal(port.available_mask(t), ref.available_mask(t))
        np.testing.assert_array_equal(port.dropout_mask(t, ids), ref.dropout_mask(t, ids))


@pytest.mark.parametrize("section", [
    {"name": "poisson", "options": {"jion_rate": 1.0}},
    {"name": "periodic", "options": {"period": 0}},
    {"name": "dropout", "options": {"rate": 1.5}},
    {"name": "churn"},
], ids=["unknown option", "period", "rate", "unknown name"])
def test_build_errors_equal_reference(section):
    with pytest.raises(ValueError) as want:
        ref_build_population(section, N)
    with pytest.raises(ValueError) as got:
        build_population(section, N)
    assert str(got.value).replace("repro_torch.", "repro.") == str(want.value)


# --------------------------------------------------------------------------
# the server's phases, side by side
# --------------------------------------------------------------------------
DATA = dict(dim=16, noise=0.8, train_per_client=60, test_per_client=10, seed=0)


class _Forced:
    """Everyone available; the listed clients drop every round."""

    def __init__(self, n_clients, drop):
        super().__init__(n_clients)
        self._drop = np.zeros(n_clients, dtype=bool)
        self._drop[list(drop)] = True

    def _availability(self, t):
        return np.ones(self.n_clients, dtype=bool)

    def dropout_mask(self, t, client_ids):
        return self._drop[np.asarray(client_ids, dtype=np.int64)]


class _HalfOnOddOff:
    """The first half available on even rounds, nobody on odd ones."""

    def _availability(self, t):
        on = np.zeros(self.n_clients, dtype=bool)
        if t % 2 == 0:
            on[: self.n_clients // 2] = True
        return on


def _processes(kind: str, n: int, **kw):
    bases = {"forced": _Forced, "blinking": _HalfOnOddOff}
    ref = type("Ref", (bases[kind], RefProcess), {})(n, **kw)
    port = type("Port", (bases[kind], PopulationProcess), {})(n, **kw)
    return ref, port


def _servers(ref_pop, port_pop, *, engine="batched", rounds=3, m=10):
    ref_ds, ds = ref_by_class_shards(**DATA), by_class_shards(**DATA)
    params = ref_init_mlp((16, 32, 10), seed=1)
    ref = RefServer(ref_ds, RefMD(ref_ds.population, m, seed=0), params, ref_sgd(0.08),
                    RefConfig(n_rounds=rounds, n_local_steps=4, batch_size=16, engine=engine),
                    population=ref_pop)
    port = FederatedServer(ds, MDSampler(ds.population, m, seed=0),
                           params_from_numpy(params, device="cpu"), sgd(0.08),
                           FLConfig(n_rounds=rounds, n_local_steps=4, batch_size=16, engine=engine),
                           population=port_pop, device="cpu")
    return ref, port


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_available, g.n_dropped, g.round_status, g.n_distinct_clients) == (
            w.n_available, w.n_dropped, w.round_status, w.n_distinct_clients)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=1e-4)


@pytest.mark.parametrize("engine", ["batched", "compat"])
@pytest.mark.parametrize("section", ["dropout", "poisson+floor", "periodic"])
def test_churned_rounds_equal_reference(section, engine):
    ref_pop = ref_build_population(SECTIONS[section], 100)
    port_pop = build_population(SECTIONS[section], 100)
    ref, port = _servers(ref_pop, port_pop, engine=engine)
    _assert_records_equal(port.run().records, ref.run().records)
    assert sum(r.n_dropped for r in port.history.records) > 0 or section == "periodic"


@pytest.mark.parametrize("engine", ["batched", "compat"])
def test_degraded_round_zeroes_the_dropped_weight_like_the_reference(engine):
    ref_pop, port_pop = _processes("forced", 100, drop=range(0, 100, 3))
    ref, port = _servers(ref_pop, port_pop, engine=engine, rounds=2)
    _assert_records_equal(port.run().records, ref.run().records)
    rec = port.history.records[0]
    assert rec.round_status == "degraded" and rec.n_dropped > 0
    assert (rec.agg_weights[0::3] == 0).all()


def test_all_dropped_raises_empty_round():
    _, port_pop = _processes("forced", 100, drop=range(100))
    _, port = _servers(None, port_pop, rounds=1)
    with pytest.raises(EmptyRoundError, match=r"round 0.*dropped"):
        port.run_round(0)
    assert len(port.history.records) == 0


def test_skip_empty_rides_out_dead_rounds_like_the_reference():
    ref_pop, port_pop = _processes("blinking", 100)
    ref, port = _servers(ref_pop, port_pop, rounds=4)
    with pytest.raises(EmptyRoundError, match="round 1.*zero"):
        port.run()
    ref, port = _servers(ref_pop, port_pop, rounds=4)
    got = port.run(skip_empty=True).records
    _assert_records_equal(got, ref.run(skip_empty=True).records)
    assert [r.round_status for r in got] == ["ok", "empty", "ok", "empty"]
    assert got[1].n_available == 0 and np.isnan(got[1].train_loss)
    assert (got[0].agg_weights[50:] == 0).all()


def test_static_population_matches_no_population():
    a = _servers(None, None)[1].run().records
    b = _servers(None, build_population({"name": "static"}, 100))[1].run().records
    for ra, rb in zip(a, b):
        assert ra.train_loss == rb.train_loss
        np.testing.assert_array_equal(ra.agg_weights, rb.agg_weights)
        assert (ra.n_available, rb.n_available) == (-1, 100)


def test_a_sampler_without_a_mask_argument_still_runs_unmasked():
    class _OneArg(ClientSampler):
        def sample(self, round_idx):
            return SampleResult(clients=np.array([0, 1]), agg_weights=np.eye(100)[0] / 2 + np.eye(100)[1] / 2)

    _, port = _servers(None, None, rounds=1)
    port.sampler = _OneArg(port.dataset.population, 2)
    assert port.run_round(0).n_distinct_clients == 2

