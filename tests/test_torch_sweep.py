"""The port's campaign layer against the JAX package's: the same cells for the
paper's sweeps, resumable stores, the same collated summaries, spawn-pool
parity and the sweep CLI."""
import copy
import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.models.simple as port_simple
from repro.fl import sweep as ref_sweep
from repro.launch import sweep as ref_cli
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.benchmarks import fig1_controlled, fig2_dirichlet
from repro_torch.fl import sweep
from repro_torch.models.simple import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference runners live in the repo's benchmarks/
    sys.path.insert(0, str(ROOT))
from benchmarks import fig1_controlled as ref_fig1  # noqa: E402
from benchmarks import fig2_dirichlet as ref_fig2  # noqa: E402
from repro_torch.testing import pin_cpu_threads, thread_env  # noqa: E402

pin_cpu_threads()

BASE = {
    "data": {"name": "by_class_shards",
             "options": {"n_classes": 4, "clients_per_class": 3, "dim": 8, "noise": 0.8,
                         "train_per_client": 40, "test_per_client": 8}},
    "sampler": {"name": "md", "m": 4},
    "train": {"n_rounds": 3, "n_local_steps": 4, "batch_size": 16, "hidden": [16], "lr": 0.08},
}
# summary columns decided by draws alone (no float arithmetic of the model)
DISCRETE = ("mean_distinct_classes", "mean_distinct_clients", "agg_weight_var", "degraded_frac")


def _sweep(axes: "dict | None" = None, n_seeds: int = 1, root_seed: int = 7) -> dict:
    return {"base": BASE, "axes": axes or {}, "n_seeds": n_seeds, "root_seed": root_seed}


def _carried_init(dims, seed=0, device="cuda"):
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


def _csv_bytes(store) -> tuple[bytes, bytes]:
    cells_csv, summary_csv = sweep.write_collated(store)
    return cells_csv.read_bytes(), summary_csv.read_bytes()


def _rows(path: Path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


# --------------------------------------------------------------------------
# the paper's sweeps: the same cells in both packages
# --------------------------------------------------------------------------
@pytest.mark.parametrize("port,ref", [(fig1_controlled, ref_fig1), (fig2_dirichlet, ref_fig2)],
                         ids=["fig1", "fig2"])
def test_paper_sweeps_expand_to_the_references_cells(port, ref):
    assert port.SWEEP == ref.SWEEP
    got = sweep.SweepSpec.from_dict(port.SWEEP).cells()
    want = ref_sweep.SweepSpec.from_dict(ref.SWEEP).cells()
    assert [c.cell_id for c in got] == [c.cell_id for c in want]
    for g, w in zip(got, want):
        assert (g.grid_index, g.seed_index, g.overrides) == (w.grid_index, w.seed_index, w.overrides)
        assert g.spec.to_dict() == w.spec.to_dict()
        assert sweep.cell_hash(g.spec) == ref_sweep.cell_hash(w.spec) == g.cell_id
    assert (sweep.SweepSpec.from_dict(port.SWEEP).replicate_seeds()
            == ref_sweep.SweepSpec.from_dict(ref.SWEEP).replicate_seeds())


def test_labels_and_paths_match_reference():
    overrides = {"data.options.alpha": 0.01, "sampler": {"name": "md", "m": 4},
                 "train.hidden": [8, 8], "sampler.options": {"groups": [[0]]}}
    assert sweep.cell_group_label(overrides) == ref_sweep.cell_group_label(overrides)
    a, b = {"sampler": {"m": 4}}, {"sampler": {"m": 4}}
    sweep.set_by_path(a, "sampler.options.measure", "l1")
    ref_sweep.set_by_path(b, "sampler.options.measure", "l1")
    assert a == b
    with pytest.raises(ValueError, match="cannot descend"):
        sweep.set_by_path(a, "sampler.m.deep", 1)
    with pytest.raises(ValueError, match="identical spec"):
        sweep.SweepSpec.from_dict(_sweep({"sampler.name": ["md", "md"]})).cells()
    assert sweep.SUMMARY_STATS == ref_sweep.SUMMARY_STATS


# --------------------------------------------------------------------------
# resume: kill after a cell + re-invoke ⇒ byte-equal collated CSVs
# --------------------------------------------------------------------------
def test_interrupted_sweep_resumes_byte_equal(tmp_path):
    spec = sweep.SweepSpec.from_dict(_sweep({"sampler.name": ["md", "algorithm1"]}, n_seeds=2))
    uninterrupted = _csv_bytes(sweep.run_sweep(spec, tmp_path / "whole", device="cpu"))

    class Kill(Exception):
        pass

    def killer(cell, status, summary, dt):
        raise Kill()

    with pytest.raises(Kill):
        sweep.run_sweep(spec, tmp_path / "resumed", on_cell=killer, device="cpu")
    store = sweep.RunStore(tmp_path / "resumed")
    assert len(store.completed(spec.cells())) == 1
    # a kill mid-write of the 2nd cell: a torn JSONL line and no summary marker
    second = spec.cells()[1]
    store.records_path(second.cell_id).write_text('{"round": 0, "train_l')
    with pytest.raises(ValueError, match="cells incomplete"):
        sweep.collate(store)
    statuses = []
    sweep.run_sweep(spec, tmp_path / "resumed", device="cpu",
                    on_cell=lambda c, s, su, dt: statuses.append(s))
    assert sorted(statuses) == ["ran", "ran", "ran", "skipped"]
    assert _csv_bytes(store) == uninterrupted
    with pytest.raises(ValueError, match="different sweep"):
        sweep.run_sweep(_sweep(root_seed=8), tmp_path / "resumed", device="cpu")


# --------------------------------------------------------------------------
# a 2-cell × 2-seed campaign in both packages
# --------------------------------------------------------------------------
def test_campaign_summary_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    d = _sweep({"sampler.name": ["md", "algorithm2"]}, n_seeds=2)
    ref_store = ref_sweep.run_sweep(d, tmp_path / "ref")
    store = sweep.run_sweep(d, tmp_path / "port", device="cpu")
    ref_paths, paths = ref_sweep.write_collated(ref_store), sweep.write_collated(store)
    for got_path, want_path in zip(paths, ref_paths):
        got, want = _rows(got_path), _rows(want_path)
        assert len(got) == len(want) > 0 and list(got[0]) == list(want[0])
        for g, w in zip(got, want):
            for col in w:
                if any(col.startswith(s) for s in DISCRETE) or col in ("cell", "grid", "seed",
                                                                       "n_seeds", "sampler.name"):
                    assert g[col] == w[col], col
                else:
                    np.testing.assert_allclose(float(g[col]), float(w[col]), atol=1e-4, err_msg=col)
    # the per-round records carry the same draws
    for c in sweep.SweepSpec.from_dict(d).cells():
        got_h, want_h = store.read_history(c.cell_id), ref_store.read_history(c.cell_id)
        for g, w in zip(got_h.records, want_h.records):
            np.testing.assert_array_equal(g.agg_weights, w.agg_weights)


def test_spawn_workers_match_serial(tmp_path, monkeypatch):
    # the spawned workers read their thread count from the environment
    for name, n in thread_env({}).items():
        monkeypatch.setenv(name, n)
    d = _sweep({"sampler.name": ["md", "algorithm1"]})
    d["base"] = copy.deepcopy(BASE)
    d["base"]["train"].update(n_rounds=2, n_local_steps=2)
    serial = sweep.run_sweep(d, tmp_path / "serial", workers=1, device="cpu")
    pooled = sweep.run_sweep(d, tmp_path / "pooled", workers=2, device="cpu")
    assert _csv_bytes(pooled) == _csv_bytes(serial)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def _cli(*args) -> subprocess.CompletedProcess:
    env = thread_env(dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.sweep", *args], env=env,
                          cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_cli_list_cells_prints_the_references_lines(tmp_path, capsys):
    path = tmp_path / "fig2.json"
    path.write_text(json.dumps(fig2_dirichlet.SWEEP))
    ref_cli.main([str(path), "--list-cells"])
    want = capsys.readouterr().out
    out = _cli(str(path), "--list-cells")
    assert out.returncode == 0, out.stderr
    assert out.stdout == want
    assert want.splitlines()[-1] == "# 16 cells = 8 grid points x 2 seeds"


def test_cli_runs_and_collates_on_the_cpu(tmp_path):
    path = tmp_path / "one.json"
    path.write_text(json.dumps(_sweep()))
    out = _cli(str(path), "--store", str(tmp_path / "store"), "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[ran]") == 1
    assert (tmp_path / "store" / "summary.csv").exists()
    again = _cli(str(path), "--store", str(tmp_path / "store"), "--device", "cpu")
    assert again.stdout.count("[skipped]") == 1
