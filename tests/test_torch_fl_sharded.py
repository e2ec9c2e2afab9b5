"""The port's FL round, gradient store and federated LM sharded over four
CPU shards, against its own unsharded runs and the JAX reference's.

The settings are the reference's sharded tests' (``test_engine_sharded.py``:
dim 16, the 16 → 32 → 10 MLP, m = 8, 3 rounds; ``test_gradient_store.py``'s
``SHARDED_SCRIPT``: n = 8, d = 64, SRP d′ = 16), whose reference runs need
four host devices in a subprocess; here the reference runs unsharded in
this process and is the target of the reference's own sharded tolerance,
|Δθ| ≤ 1e-5 + 1e-4·max|θ| (the partials are added in another order).
Against the port's unsharded run: per-client updates within 1e-6 of their
scale, losses within 1e-4, plans equal; ``"auto"`` (one shard here) bit
for bit; the exact and SRP stores bit-equal; the federated LM's losses
within ``STEP_ATOL``.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro_torch.models.simple as port_simple
from _torch_fl_lm import STEP_ATOL, configs, ref_params
from repro.core import ClientPopulation as RefPopulation
from repro.core.samplers.algorithm2 import Algorithm2Sampler as RefAlgorithm2
from repro.core.samplers.md import MDSampler as RefMD
from repro.fl import experiment as ref_exp
from repro.fl.gradient_store import GradientStore as RefStore
from repro.fl.partition import by_class_shards as ref_by_class_shards
from repro.fl.server import FederatedServer as RefServer, FLConfig as RefFLConfig
from repro.launch import fl_train as ref_fl
from repro.models.simple import init_mlp as ref_init_mlp
from repro.optim import sgd as ref_sgd
from repro_torch.core import ClientPopulation
from repro_torch.core.samplers.algorithm2 import Algorithm2Sampler
from repro_torch.core.samplers.md import MDSampler
from repro_torch.fl import experiment as exp
from repro_torch.fl.aggregation import flatten_params
from repro_torch.fl.engine import staged_bytes
from repro_torch.fl.gradient_store import GradientStore
from repro_torch.fl.partition import by_class_shards
from repro_torch.fl.server import FederatedServer, FLConfig
from repro_torch.launch import fl_train
from repro_torch.launch.mesh import ShardedRows, make_host_mesh, resolve_fl_mesh
from repro_torch.models import model as mdl
from repro_torch.models.simple import params_from_numpy
from repro_torch.optim.sgd import sgd
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

DATA = dict(dim=16, noise=0.8, train_per_client=60, test_per_client=10, seed=0)
DS = by_class_shards(**DATA)
M, ROUNDS, STEPS, BATCH, LR, SEED = 8, 3, 6, 32, 0.08, 7
INIT = {k: np.asarray(v) for k, v in ref_init_mlp((16, 32, 10), seed=1).items()}
D = sum(v.size for v in INIT.values())


def _sampler(kind, mesh, pop=DS.population):
    if kind == "md":
        return MDSampler(pop, M, seed=SEED)
    return Algorithm2Sampler(pop, M, update_dim=D, seed=SEED, device="cpu", store_mesh_spec=mesh)


def _run(kind, mesh, ds=DS):
    """(θ, losses, per-round updates by client, plans, server) of a 3-round run."""
    cfg = FLConfig(n_rounds=ROUNDS, n_local_steps=STEPS, batch_size=BATCH, seed=0, mesh_spec=mesh)
    sampler = _sampler(kind, mesh, ds.population)
    seen, plans = [], []
    real = sampler.observe_updates

    def observe(ids, updates):
        rows = updates.gather("cpu") if isinstance(updates, ShardedRows) else updates
        seen.append(dict(zip(np.asarray(ids).tolist(), rows.numpy().copy())))
        real(ids, updates)

    sampler.observe_updates = observe

    def on_round(rec):
        plan = sampler.plan
        plans.append(None if plan is None or plan.r_tokens is None else plan.r_tokens.copy())

    srv = FederatedServer(ds, sampler, params_from_numpy(INIT, device="cpu"), sgd(LR), cfg,
                          device="cpu")
    with srv:
        srv.run(on_round=on_round)
    if not seen:  # md observes no updates
        seen = None
    return flatten_params(srv.params).numpy(), srv.history.series("train_loss"), seen, plans, srv


@pytest.fixture(scope="module")
def runs():
    out = {}
    for kind in ("md", "algorithm2"):
        out[kind] = {spec: _run(kind, spec) for spec in (None, "4x1", "auto")}
    return out


def _reference_theta(kind):
    ds = ref_by_class_shards(**DATA)
    sampler = (RefMD(ds.population, M, seed=SEED) if kind == "md"
               else RefAlgorithm2(ds.population, M, update_dim=D, seed=SEED))
    cfg = RefFLConfig(n_rounds=ROUNDS, n_local_steps=STEPS, batch_size=BATCH, seed=0)
    with RefServer(ds, sampler, dict(INIT), ref_sgd(LR), cfg) as srv:
        srv.run()
        return np.concatenate([np.asarray(srv.params[k]).ravel() for k in sorted(srv.params)])


@pytest.mark.parametrize("kind", ["md", "algorithm2"])
def test_sharded_round_matches_the_references_unsharded_run(runs, kind):
    theta, losses = runs[kind]["4x1"][:2]
    want = _reference_theta(kind)
    assert np.abs(theta - want).max() <= 1e-5 + 1e-4 * np.abs(want).max()
    ref_losses = runs[kind][None][1]
    assert np.abs(losses - ref_losses).max() <= 1e-4


@pytest.mark.parametrize("kind", ["md", "algorithm2"])
def test_sharded_round_matches_the_ports_unsharded_run(runs, kind):
    (t1, l1, u1, p1, _), (t4, l4, u4, p4, _) = runs[kind][None], runs[kind]["4x1"]
    assert np.abs(t4 - t1).max() <= 1e-5 + 1e-4 * np.abs(t1).max()
    assert np.abs(l4 - l1).max() <= 1e-4
    if kind == "algorithm2":
        assert len(u1) == len(u4) == ROUNDS
        for r1, r4 in zip(u1, u4):
            assert r1.keys() == r4.keys()
            for cid in r1:
                scale = np.abs(r1[cid]).max()
                assert np.abs(r4[cid] - r1[cid]).max() <= 1e-6 * scale
        assert all(np.array_equal(a, b) for a, b in zip(p1, p4))


@pytest.mark.parametrize("kind", ["md", "algorithm2"])
def test_auto_mesh_spec_is_the_unsharded_run_bit_for_bit(runs, kind):
    (t1, l1, _, p1, _), (ta, la, _, pa, srv) = runs[kind][None], runs[kind]["auto"]
    assert srv.mesh.shape == {"data": 1, "model": 1}
    np.testing.assert_array_equal(ta, t1)
    np.testing.assert_array_equal(la, l1)
    assert all(np.array_equal(a, b) for a, b in zip(p1, pa))


def test_client_sharded_staging_shrinks_per_device_bytes(runs):
    one, four = runs["md"][None][4], runs["md"]["4x1"][4]
    # 100 clients over 4 data groups: each shard pins a quarter of the set
    assert four._engine.per_device_staged_bytes() * 4 == one._engine.per_device_staged_bytes()
    assert len(four._engine.staged_bytes_by_position()) == 4
    est1 = staged_bytes(DS, M, STEPS, BATCH)
    est4 = staged_bytes(DS, M, STEPS, BATCH, mesh=resolve_fl_mesh("4x1", device="cpu"))
    assert est4 * 4 == est1
    # the reference's estimate divides the same terms (its dtypes differ)
    from repro.fl.engine import staged_bytes as ref_staged_bytes

    class _FourWay:  # the reference's helpers read only these
        axis_names, shape = ("data", "model"), {"data": 4, "model": 1}

    assert ref_staged_bytes(DS, M, STEPS, BATCH, mesh=_FourWay()) * 4 == ref_staged_bytes(
        DS, M, STEPS, BATCH)


def test_uneven_client_count_is_staged_replicated():
    ds = by_class_shards(dim=16, n_classes=5, clients_per_class=2, train_per_client=20,
                         test_per_client=5, seed=0)  # 10 clients over 4 shards
    params = params_from_numpy(INIT, device="cpu")
    cfg = FLConfig(n_rounds=2, n_local_steps=2, batch_size=8, mesh_spec="4x1")
    srv = FederatedServer(ds, MDSampler(ds.population, 5, seed=0), params, sgd(LR), cfg,
                          device="cpu")
    whole = FederatedServer(ds, MDSampler(ds.population, 5, seed=0), params, sgd(LR),
                            FLConfig(n_rounds=2, n_local_steps=2, batch_size=8), device="cpu")
    assert srv._engine.staged_bytes_by_position() == [whole._engine.per_device_staged_bytes()] * 4
    assert staged_bytes(ds, 5, 2, 8, mesh=srv.mesh) == staged_bytes(ds, 5, 2, 8)
    # 5 slots over 4 groups: 2, 2, 1, 0 — the run still matches
    with srv, whole:
        np.testing.assert_allclose(srv.run().series("train_loss"),
                                   whole.run().series("train_loss"), atol=1e-4)


def test_staging_budget_is_per_device():
    params = params_from_numpy(INIT, device="cpu")
    need = staged_bytes(DS, M, STEPS, BATCH)
    cfg = dict(n_rounds=1, n_local_steps=STEPS, batch_size=BATCH, max_staged_bytes=need // 2)
    with pytest.warns(UserWarning, match="per device"):
        srv = FederatedServer(DS, MDSampler(DS.population, M), params, sgd(LR), FLConfig(**cfg),
                              device="cpu")
    assert srv._engine is None and srv.mesh is None
    srv = FederatedServer(DS, MDSampler(DS.population, M), params, sgd(LR),
                          FLConfig(**cfg, mesh_spec="4x1"), device="cpu")
    assert srv._engine is not None and srv.mesh.shape["data"] == 4


# --------------------------------------------------------------------------
# the gradient store (test_gradient_store.py's SHARDED_SCRIPT)
# --------------------------------------------------------------------------
N_S, D_S, DP_S = 8, 64, 16


def _store_pair(**kw):
    return (GradientStore(N_S, D_S, device="cpu", **kw),
            GradientStore(N_S, D_S, mesh_spec="4x1", device="cpu", **kw))


@pytest.mark.parametrize("sketch", [{}, {"sketch": "srp", "sketch_dim": DP_S}], ids=["exact", "srp"])
def test_sharded_store_is_bit_equal_to_unsharded(sketch):
    rng = np.random.default_rng(0)
    plain, shard = _store_pair(staleness_decay=0.9, **sketch)
    for r in range(3):
        ids = rng.integers(0, N_S + 2, size=5)
        vals = rng.normal(size=(5, D_S)).astype(np.float32)
        plain.update(ids, vals)
        if r == 1:  # rows as a sharded round hands them over: blocks by data group
            t = torch.from_numpy(vals)
            shard.update(ids, ShardedRows([t[:2], t[2:4], t[4:]], D_S))
        else:
            shard.update(ids, vals)
    h = rng.normal(size=(2, D_S)).astype(np.float32)  # harvested rows, decay-free
    plain.scatter_scaled([3, 6], h, scale=0.5)
    shard.scatter_scaled([3, 6], h, scale=0.5)
    np.testing.assert_array_equal(shard.asnumpy(), plain.asnumpy())
    np.testing.assert_array_equal(shard.snapshot().numpy(), plain.snapshot().numpy())
    assert len(shard._blocks) == 4 and [b[0].shape[0] for b in shard._blocks] == [2, 2, 2, 2]
    assert shard.bytes_by_position() == [2 * shard.dim * 4] * 4
    assert shard.nbytes == plain.nbytes == N_S * shard.dim * 4
    np.testing.assert_array_equal(shard.gather_rows(np.array([1, 6])).numpy(),
                                  plain.gather_rows(np.array([1, 6])).numpy())
    np.testing.assert_array_equal(shard.gather_rows(np.array([7, 0, 4])).numpy(),
                                  plain.gather_rows(np.array([7, 0, 4])).numpy())
    # load(): a tensor or an array, re-placed onto the blocks
    again = GradientStore(N_S, D_S, mesh_spec="4x1", device="cpu", **sketch)
    again.load(shard.snapshot())
    np.testing.assert_array_equal(again.asnumpy(), shard.asnumpy())
    back = GradientStore(N_S, D_S, device="cpu", **sketch)
    back.load(shard.asnumpy())
    np.testing.assert_array_equal(back.asnumpy(), plain.asnumpy())


def test_sharded_store_matches_the_references_and_resumes_its_state():
    rng = np.random.default_rng(0)
    ref = RefStore(N_S, D_S, sketch="srp", sketch_dim=DP_S)
    port = GradientStore(N_S, D_S, sketch="srp", sketch_dim=DP_S, mesh_spec="4x1", device="cpu")
    for _ in range(3):
        ids = rng.integers(0, N_S + 2, size=5)
        vals = rng.normal(size=(5, D_S)).astype(np.float32)
        ref.update(ids, vals)
        port.update(ids, vals)
    np.testing.assert_allclose(port.asnumpy(), ref.asnumpy(), atol=1e-5)
    # a state written by the reference's unsharded store resumes sharded
    resumed = GradientStore(N_S, D_S, sketch="srp", sketch_dim=DP_S, mesh_spec="4x1", device="cpu")
    resumed.load(ref.asnumpy())
    np.testing.assert_array_equal(resumed.asnumpy(), ref.asnumpy())
    # and the sharded store's state resumes in the reference's
    ref2 = RefStore(N_S, D_S, sketch="srp", sketch_dim=DP_S)
    ref2.load(port.asnumpy())
    np.testing.assert_array_equal(ref2.asnumpy(), port.asnumpy())


def test_uneven_store_is_replicated():
    odd = GradientStore(N_S + 1, D_S, sketch="srp", sketch_dim=DP_S, mesh_spec="4x1", device="cpu")
    assert len(odd._blocks) == 1 and len(odd._blocks[0]) == 4
    odd.update(np.array([0]), np.ones((1, D_S), np.float32))
    assert np.any(odd.asnumpy()[0] != 0)
    assert all(torch.equal(b, odd._blocks[0][0]) for b in odd._blocks[0])


@pytest.mark.parametrize("name,options", [
    ("algorithm2", {}), ("stratified", {}), ("dp_stratified", {}), ("hybrid", {}),
    ("importance", {}),
])
def test_every_store_backed_sampler_takes_store_mesh_spec(name, options):
    pop = ClientPopulation(np.full(8, 50))
    sampler = exp.build_sampler({"name": name, "m": 4, "options": options}, pop, update_dim=12,
                                store_mesh_spec="4x1", device="cpu")
    with contextlib.closing(sampler):
        store = sampler.gradient_store
        assert store.mesh.shape == {"data": 4, "model": 1} and len(store._blocks) == 4
        rows = np.random.default_rng(1).normal(size=(4, 12)).astype(np.float32)
        sampler.sample(0)
        sampler.observe_updates(np.array([0, 3, 5, 6]), rows)
        np.testing.assert_array_equal(store.gather_rows([3, 6]).numpy(), rows[[1, 3]])
    ref = ref_exp.build_sampler({"name": name, "m": 4, "options": options},
                                RefPopulation(np.full(8, 50)), update_dim=12)
    ref.close()


# --------------------------------------------------------------------------
# a bundle crosses between a sharded and an unsharded server, either way
# --------------------------------------------------------------------------
BUNDLE = {
    "data": {"name": "by_class_shards",
             "options": {"clients_per_class": 2, "train_per_client": 40, "dim": 8,
                         "n_classes": 4, "seed": 0}},
    "sampler": {"name": "algorithm2", "m": 4, "seed": 3},
    "train": {"n_rounds": 5, "n_local_steps": 3, "batch_size": 10, "seed": 1},
    "scheduler": {"name": "deadline", "options": {"straggle_frac": 0.5, "harvest_discount": 0.5}},
}
KILL = 3


def _carried_init(dims, seed=0, device="cuda"):
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


def _records(srv, start=0):
    recs, plans = [], []

    def on_round(rec):
        recs.append(rec)
        plans.append(srv.sampler.plan.r_tokens.copy())

    if start:
        assert srv.resume() == start
    srv.run(on_round=on_round)
    return recs, plans


@pytest.mark.parametrize("writer,reader", [("reference", "port[4x1]"), ("port[4x1]", "reference"),
                                           ("port", "port[4x1]")])
def test_bundle_resumes_sharded_and_unsharded(tmp_path, monkeypatch, writer, reader):
    """A bundle written at round 3 by one server resumes in the other, the
    sharded port's among them, and the continuation matches the writer's
    uninterrupted run: plans and weights equal, losses within 1e-4."""
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    path = str(tmp_path / "ck.npz")
    build = {
        "reference": lambda **kw: ref_exp.build_experiment(BUNDLE, **kw),
        "port": lambda **kw: exp.build_experiment(BUNDLE, device="cpu", **kw),
        "port[4x1]": lambda **kw: exp.build_experiment(
            {**BUNDLE, "engine": {"mesh_spec": "4x1"}}, device="cpu", **kw),
    }
    with build[writer]() as srv:
        recs, plans = _records(srv)
        want = (recs[KILL:], plans[KILL:])
    with build[writer](checkpoint_path=path) as srv:
        for t in range(KILL):
            srv.run_round(t)
        srv.checkpoint()
    with build[reader](checkpoint_path=path) as srv:
        got = _records(srv, start=KILL)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_late, g.n_harvested, g.plan_version) == (w.n_late, w.n_harvested, w.plan_version)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=1e-4)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the federated LM over four CPU shards
# --------------------------------------------------------------------------
LM_FL = dict(n_clients=8, m=4, n_rounds=2, n_local_steps=2, local_batch=2, seq_len=16, lr=0.1)


def _lm_run(sampler, planner, mesh, monkeypatch):
    _, cfg = configs()
    tree = ref_params()
    monkeypatch.setattr(mdl, "init_params",
                        lambda c, seed=0, device="cuda": mdl.params_from_numpy(c, tree, device=device))
    fl = fl_train.FLLMConfig(**LM_FL, sampler=sampler, planner=planner)
    d = mdl.param_count(mdl.init_params(cfg, 0, device="cpu"))
    with contextlib.closing(fl_train.make_lm_sampler(fl, ClientPopulation(np.full(8, 100)),
                                                     update_dim=d, device="cpu")) as sm:
        losses = fl_train.run_federated_lm(cfg, fl, sm, mesh=mesh, device="cpu")
        store = getattr(sm, "gradient_store", None)
        return losses, None if store is None else store.asnumpy()


@pytest.mark.parametrize("sampler,planner", [
    ("algorithm1", "sync"), ("algorithm2", "sync"),
    ("algorithm2", {"mode": "sync", "sketch": "srp", "sketch_dim": 16}),
], ids=["algorithm1", "algorithm2", "algorithm2[srp]"])
def test_federated_lm_over_four_shards_matches_unsharded(monkeypatch, sampler, planner):
    want, want_G = _lm_run(sampler, planner, None, monkeypatch)
    got, got_G = _lm_run(sampler, planner, make_host_mesh(4, 1, device="cpu"), monkeypatch)
    np.testing.assert_allclose(got, want, atol=STEP_ATOL, rtol=0)
    if want_G is not None:
        np.testing.assert_allclose(got_G, want_G, atol=STEP_ATOL, rtol=0)


def test_federated_lm_m_guard_raises_the_references_error():
    _, cfg = configs()
    fl = fl_train.FLLMConfig(**{**LM_FL, "m": 2}, sampler="md")
    with pytest.raises(ValueError) as got:
        fl_train.run_federated_lm(cfg, fl, None, mesh=make_host_mesh(4, 1, device="cpu"),
                                  device="cpu")
    assert "fl.m=2 must be a multiple of the mesh's data-parallel degree 4" in str(got.value)


def test_round_input_specs_and_shardings_have_the_references_shapes():
    ref_cfg, cfg = configs()
    want = ref_fl.fl_input_specs(ref_cfg, 4, 2, 2, 16)
    got = fl_train.fl_input_specs(cfg, 4, 2, 2, 16)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert got[k].device.type == "meta"
    assert got["client_tokens"].dtype == torch.int64 and got["weights"].dtype == torch.float32
    from repro.launch.mesh import make_host_mesh as ref_host_mesh

    ref_sh = ref_fl.fl_round_shardings(ref_host_mesh(1, 1))
    sh = fl_train.fl_round_shardings(make_host_mesh(4, 1, device="cpu"))
    assert list(sh) == list(ref_sh)
    for k in ref_sh:
        assert sh[k].spec == tuple(ref_sh[k].spec)


# --------------------------------------------------------------------------
# chip_smoke.py's sharded gates, held against wrong answers on the CPU
# --------------------------------------------------------------------------
def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("rows,slots,want", [(10, 10, 4), (9, 10, 3), (6, 10, 2), (7, 8, 4),
                                             (2, 8, 1), (5, 5, 3)])
def test_smoke_counts_the_shards_that_hold_observed_rows(rows, slots, want):
    assert _smoke()._nonempty_blocks(rows, slots) == want


@pytest.mark.parametrize("sketch", [{}, {"sketch": "srp", "sketch_dim": DP_S}], ids=["exact", "srp"])
@pytest.mark.parametrize("wrong", [None, "row", "stale"])
def test_smoke_store_gate_rejects_a_wrong_sharded_store(monkeypatch, sketch, wrong):
    """The gate accepts the sharded store fed the round's updates and
    rejects one with a row written from another client's update, or a
    round's write lost."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "DEV", "cpu")
    rng = np.random.default_rng(3)
    store = GradientStore(N_S, D_S, mesh_spec="4x1", device="cpu", **sketch)
    observed = []
    for r in range(3):
        ids = rng.choice(N_S, size=4, replace=False)
        rows = (1e-3 * rng.normal(size=(4, D_S))).astype(np.float32)
        observed.append((ids, rows))
        if wrong == "stale" and r == 2:
            continue
        fed = rows[::-1].copy() if wrong == "row" and r == 1 else rows
        store.update(ids, fed)
    if wrong is None:
        held = smoke._store_against_replay(torch, "t", store, observed, sketch)
        assert held == "bit-equal" or held.startswith("within B3's limit")
    else:
        with pytest.raises(RuntimeError, match="differs"):
            smoke._store_against_replay(torch, "t", store, observed, sketch)


def test_round_step_over_a_mesh_takes_plain_tensors():
    """``batched_round_step(mesh=)`` on (n, n_pad, …) tensors, as the
    reference's takes arrays: each group gathers its slots from them; 10
    slots over 4 groups are 3, 3, 3, 1."""
    from repro_torch.fl.engine import batched_round_step
    from repro_torch.models.simple import classification_loss

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(12, 30, 16)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(12, 30)))
    slots = rng.choice(12, size=10, replace=False)
    idx = rng.integers(0, 30, size=(10, 5, 8))
    w = (rng.dirichlet(np.ones(10)) * 0.8).astype(np.float32)
    args = dict(loss_fn=classification_loss, opt=sgd(0.1))
    p0 = params_from_numpy(INIT, device="cpu")
    want = batched_round_step(p0, x, y, torch.from_numpy(slots), torch.from_numpy(idx), w, 0.2,
                              **args)
    got = batched_round_step(p0, x, y, slots, idx, w, 0.2, mesh=make_host_mesh(4, 1, device="cpu"),
                             **args)
    assert [b.shape[0] for b in got[1].blocks] == [3, 3, 3, 1] and got[1].groups == [0, 1, 2, 3]
    np.testing.assert_allclose(got[1].gather("cpu").numpy(), want[1].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=0, atol=1e-6)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k].numpy(), want[0][k].numpy(), rtol=0, atol=1e-6)
