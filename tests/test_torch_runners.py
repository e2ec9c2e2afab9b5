"""The port's Appendix D ablations, beyond-paper runner and benchmark doors
(``--spec``, ``--sweep``, ``--list``) against the repo's JAX runners: the
same sweep dicts, the same cells run side by side with the reference's MLP
initialisation carried across (equal draws and plans, losses to 1e-4), the
same plan-check row and the same registry names."""
import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.models.simple as port_simple
from repro.fl import experiment as ref_exp
from repro.fl import sweep as ref_sweep
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.benchmarks import ablations, beyond_paper
from repro_torch.benchmarks import run as port_run
from repro_torch.fl import experiment as exp
from repro_torch.fl import sweep as port_sweep
from repro_torch.models.simple import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference runners live in the repo's benchmarks/
    sys.path.insert(0, str(ROOT))
from benchmarks import ablations as ref_ablations  # noqa: E402
from benchmarks import beyond_paper as ref_beyond  # noqa: E402
from benchmarks import run as ref_run  # noqa: E402
from repro_torch.testing import pin_cpu_threads  # noqa: E402

pin_cpu_threads()

CELL_ROUNDS = 2
LOSS_ATOL = 1e-4

SWEEP_NAMES = {
    "D2": ("SWEEP_D2", ablations, ref_ablations),
    "D4_N": ("SWEEP_D4_N", ablations, ref_ablations),
    "D4_M": ("SWEEP_D4_M", ablations, ref_ablations),
    "D5": ("SWEEP_D5", ablations, ref_ablations),
    "STALENESS": ("SWEEP_STALENESS", beyond_paper, ref_beyond),
    "CHURN": ("SWEEP_CHURN", beyond_paper, ref_beyond),
}
# one cell of each sweep: {axis path: value}
CELLS = {
    "D2": {"sampler.options.measure": "l2"},
    "D4_N": {"train.n_local_steps": 20, "sampler.name": "algorithm2"},
    "D4_M": {"sampler.m": 5, "sampler.name": "algorithm2"},
    "D5": {"sampler.name": "algorithm2"},
    "STALENESS": {"sampler.options.staleness_decay": 0.5},
    "CHURN": {"population": {"name": "poisson", "options": {"join_rate": 0.3, "leave_rate": 0.3}}},
}


def _carried_init(dims, seed=0, device="cuda"):
    """The reference's initial parameters, carried into the port."""
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


@pytest.mark.parametrize("name", SWEEP_NAMES)
def test_sweep_dicts_equal_reference(name):
    attr, port_mod, ref_mod = SWEEP_NAMES[name]
    got, want = getattr(port_mod, attr), getattr(ref_mod, attr)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert list(got) == list(want) and list(got["axes"]) == list(want["axes"])
    got_cells = port_sweep.SweepSpec.from_dict(got).cells()
    want_cells = ref_sweep.SweepSpec.from_dict(want).cells()
    assert [c.cell_id for c in got_cells] == [c.cell_id for c in want_cells]


def test_module_constants_equal_reference():
    for port_mod, ref_mod in ((ablations, ref_ablations), (beyond_paper, ref_beyond)):
        assert (port_mod.DIM, port_mod.ROUNDS, port_mod.DATA) == (ref_mod.DIM, ref_mod.ROUNDS, ref_mod.DATA)
    assert [label for _, label, _ in ablations.SWEEPS] == [
        "ablation_D2", "ablation_D4_N", "ablation_D4_m", "ablation_D5_fedprox"]


def _cell_spec(sweep: dict, choice: dict) -> dict:
    """The spec dict of the cell of ``sweep`` whose axes take ``choice``,
    cut to CELL_ROUNDS rounds."""
    d = copy.deepcopy(sweep)
    port_sweep.set_by_path(d, "base.train.n_rounds", CELL_ROUNDS)
    (cell,) = [c for c in port_sweep.SweepSpec.from_dict(d).cells() if c.overrides == choice]
    (ref_cell,) = [c for c in ref_sweep.SweepSpec.from_dict(d).cells() if c.overrides == choice]
    assert cell.cell_id == ref_cell.cell_id
    return cell.spec.to_dict()


def _run(srv):
    recs, plans = [], []

    def on_round(rec):
        recs.append(rec)
        plan = getattr(srv.sampler, "plan", None)
        plans.append(None if plan is None or plan.r_tokens is None else np.array(plan.r_tokens))

    with srv:
        srv.run(on_round=on_round)
    return recs, plans


@pytest.mark.parametrize("name", CELLS)
def test_one_cell_of_each_sweep_matches_reference(name, monkeypatch):
    attr, port_mod, _ = SWEEP_NAMES[name]
    spec = _cell_spec(getattr(port_mod, attr), CELLS[name])
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    want, want_plans = _run(ref_exp.build_experiment(spec))
    got, got_plans = _run(exp.build_experiment(spec, device="cpu"))
    assert len(got) == len(want) == CELL_ROUNDS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.agg_weights, w.agg_weights)
        assert (g.n_distinct_clients, g.n_available, g.n_dropped) == (
            w.n_distinct_clients, w.n_available, w.n_dropped)
        np.testing.assert_allclose(g.train_loss, w.train_loss, atol=LOSS_ATOL)
        np.testing.assert_allclose(g.test_acc, w.test_acc, atol=LOSS_ATOL)
    assert [p is None for p in got_plans] == [p is None for p in want_plans]
    for g, w in zip(got_plans, want_plans):
        if g is not None:
            np.testing.assert_array_equal(g, w)


def test_plan_check_row_equals_reference():
    """The port's check (the similarity op under the reference's backend
    name, on the CPU) gives the reference's row, and both of its plans
    equal the reference's host and device plans bit for bit."""
    from repro.core import validate_plan as ref_validate

    same, host, dev = beyond_paper.plan_check(device="cpu", backend="pallas-interpret")
    ds = ref_exp.build_dataset(ref_exp.DataSpec.from_dict(ref_beyond.DATA))
    pop = ds.population
    G = np.random.default_rng(0).normal(size=(pop.n_clients, beyond_paper.PLAN_DIM))
    ref_host, ref_dev = (
        ref_exp.build_sampler({"name": "algorithm2", "m": 10, "options": {"distance_fn": b}}, pop,
                              update_dim=beyond_paper.PLAN_DIM)
        for b in ("numpy", "pallas-interpret"))
    for s in (ref_host, ref_dev):
        s.observe_updates(np.arange(pop.n_clients), G)
    ref_validate(ref_dev.plan, pop)
    want = np.allclose(ref_host.plan.r, ref_dev.plan.r)
    assert f"identical={same}" == f"identical={want}" == "identical=True"
    for got_plan, want_plan in ((host, ref_host.plan), (dev, ref_dev.plan)):
        np.testing.assert_array_equal(got_plan.r, want_plan.r)
        np.testing.assert_array_equal(got_plan.r_tokens, want_plan.r_tokens)
    ref_host.close()
    ref_dev.close()


def test_list_names_equal_reference_registry_by_registry(capsys):
    ref_run.list_registered()
    want = dict(line.split(":", 1) for line in capsys.readouterr().out.splitlines())
    port_run.main(["--list"])
    got = dict(line.split(":", 1) for line in capsys.readouterr().out.splitlines())
    assert list(got) == list(want)
    for key in want:
        if key != "benchmarks":
            assert got[key].split() == want[key].split(), key
    # the port's runners only, in the reference's order
    ported = got["benchmarks"].split()
    assert ported == [n for n in want["benchmarks"].split() if n in ported]
    assert ported == [name for name, _ in port_run.MODULES]
    assert set(ported) == {"table_variance", "bench_sampler_cost", "bench_round_engine",
                           "bench_engine_sharded", "bench_async_planner", "bench_store_scale",
                           "bench_scheduler", "bench_fl_collectives", "bench_kernels",
                           "bench_dryrun_roofline", "fig1_controlled", "fig2_dirichlet",
                           "scheme_race", "ablations", "beyond_paper"}
    # every module of the reference is ported, its roofline runner too
    assert set(want["benchmarks"].split()) == set(ported)


SPEC = {
    "data": {"name": "by_class_shards",
             "options": {"n_classes": 4, "clients_per_class": 3, "dim": 8,
                         "train_per_client": 30, "test_per_client": 8, "seed": 0}},
    "sampler": {"name": "algorithm2", "m": 4},
    "train": {"n_rounds": 3, "n_local_steps": 2, "batch_size": 10, "hidden": [8], "lr": 0.05},
}


def _rows(text: str) -> dict:
    """{row name: {key: value}} of ``name,us,derived`` rows (header skipped)."""
    rows = {}
    for line in text.splitlines():
        if line.startswith("#") or line == "name,us_per_call,derived":
            continue
        name, _us, derived = line.split(",", 2)
        rows[name] = dict(kv.split("=") for kv in derived.split(";"))
    return rows


def test_spec_door_rows_equal_reference_to_four_decimals(capsys, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    ref_run.run_one_spec(json.dumps(SPEC))
    want = _rows(capsys.readouterr().out)
    port_run.main(["--spec", json.dumps(SPEC), "--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    assert list(got) == list(want) == [f"spec/by_class_shards/algorithm2/round={t}"
                                       for t in range(3)] + ["spec/by_class_shards/algorithm2"]
    for name in want:
        assert list(got[name]) == list(want[name])
        for key, value in want[name].items():
            if key in ("loss", "acc"):  # printed to 4 (acc 3) decimals from values within 1e-4
                assert abs(float(got[name][key]) - float(value)) <= 2e-4, (name, key)
            else:
                assert got[name][key] == value, (name, key)


def test_sweep_door_resumes_to_identical_collated_csvs(tmp_path, capsys):
    sweep = {"base": SPEC, "axes": {"sampler.name": ["md", "algorithm2"]}, "n_seeds": 1,
             "root_seed": 5}
    store = tmp_path / "store"
    args = ["--sweep", json.dumps(sweep), "--store", str(store), "--device", "cpu"]
    port_run.main(args)
    first = capsys.readouterr().out
    csvs = {p.name: p.read_text() for p in store.glob("*.csv")}
    assert set(csvs) == {"cells.csv", "summary.csv"}
    port_run.main(args)
    again = capsys.readouterr().out
    assert {p.name: p.read_text() for p in store.glob("*.csv")} == csvs
    ran = [r for r in first.splitlines() if r.startswith("sweep/")]
    resumed = [r for r in again.splitlines() if r.startswith("sweep/")]
    assert len(ran) == len(resumed) == 2
    assert all("status=ran" in r for r in ran) and all("status=skipped" in r for r in resumed)
    # the cells' names and losses are the rows of the same campaign run again
    assert [r.split(",")[0] for r in ran] == [r.split(",")[0] for r in resumed]
    assert [r.split(";")[-1] for r in ran] == [r.split(";")[-1] for r in resumed]


@pytest.mark.parametrize("argv", [[], ["--spec", json.dumps(SPEC)]])
def test_run_defaults_to_cuda_and_raises_without_it(argv):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_run.main(argv)


@pytest.mark.parametrize("runner", [ablations, beyond_paper])
def test_runners_default_to_cuda_and_raise_without_it(runner):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main([])
