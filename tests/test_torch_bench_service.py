"""The port's ``bench_async_planner --drift``, ``bench_service_churn`` and
``bench_scheduler`` against the repo's JAX modules (``benchmarks/``), each
at ``--smoke`` with ``--device cpu`` and the reference's MLP initialisation
carried into the port (as ``test_torch_runners.py``'s spec door): the same
row names in the same order, the drift section's rebuilds and mean drift,
the churn and scheduler sweeps' rounds-to-accuracy, degraded fraction,
late and harvested counts and parity equal, final accuracy to 2e-4
(printed to 4 decimals from values within 1e-4)."""
import re
import sys
from pathlib import Path

import pytest

import repro_torch.models.simple as port_simple
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.benchmarks import bench_async_planner, bench_scheduler, bench_service_churn
from repro_torch.fl.experiment import DATASETS
from repro_torch.models.simple import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference modules live in the repo's benchmarks/
    sys.path.insert(0, str(ROOT))
from benchmarks import bench_async_planner as ref_async  # noqa: E402
from benchmarks import bench_scheduler as ref_scheduler  # noqa: E402
from benchmarks import bench_service_churn as ref_churn  # noqa: E402
from repro_torch.testing import pin_cpu_threads  # noqa: E402

pin_cpu_threads()

ACC_ATOL = 2e-4
EQUAL_KEYS = ("rounds_to_acc0.9", "degraded_frac", "n_late", "n_harvested", "parity")


def _carried_init(dims, seed=0, device="cuda"):
    """The reference's initial parameters, carried into the port."""
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


def _rows(text: str) -> list[tuple[str, dict]]:
    """(name, {key: value}) of ``name,us,derived`` lines: the derived
    column's ``key=value`` words, whether ``;`` or a space parts them."""
    out = []
    for line in text.splitlines():
        name, us, derived = line.split(",", 2)
        assert float(us) > 0, line
        out.append((name, dict(re.findall(r"([\w.]+)=([^;\s]+)", derived))))
    return out


def _pair(capsys, monkeypatch, ref_main, port_main, argv):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    ref_main(argv)
    want = _rows(capsys.readouterr().out)
    port_main(argv + ["--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    assert [n for n, _ in got] == [n for n, _ in want]
    return got, want


def test_async_planner_drift_rows_equal_reference(capsys, monkeypatch):
    got, want = _pair(capsys, monkeypatch, ref_async.main, bench_async_planner.main,
                      ["--smoke", "--drift"])
    assert "random_clients" in DATASETS
    drift = [(n, g, w) for (n, g), (_, w) in zip(got, want) if n.startswith("drift_planner/")]
    assert [n for n, _, _ in drift] == ["drift_planner/n=40/fixed",
                                        "drift_planner/n=40/threshold=0.2"]
    for name, g, w in drift:
        assert g["rebuilds"] == w["rebuilds"], name
        assert g.get("mean_drift") == w.get("mean_drift"), name
    sync = dict(got)["async_planner/n=40/sync"]
    assert sync["lag"] == "0"
    for d in ("one_shot", "streamed"):  # one split at (24, 96): no scratch
        f = dict(got)[f"similarity_streamed/n=24/d=96/{d}"]
        assert f["split_scratch"] == "0.00MiB" and f["splits"] == "1"


@pytest.mark.parametrize("name", ["service_churn", "scheduler"])
def test_churn_and_scheduler_rows_equal_reference(name, capsys, monkeypatch):
    ref_main, port_main = {"service_churn": (ref_churn.main, bench_service_churn.main),
                           "scheduler": (ref_scheduler.main, bench_scheduler.main)}[name]
    got, want = _pair(capsys, monkeypatch, ref_main, port_main, ["--smoke"])
    labels = ref_churn.SCENARIOS if name == "service_churn" else ref_scheduler.POLICIES
    assert [n for n, _ in got] == [f"{name}/{label}" for label, _ in labels]
    assert got[0][1]["parity"] == "bit-identical"
    for (row, g), (_, w) in zip(got, want):
        assert set(g) == set(w), row
        for key in EQUAL_KEYS:
            assert g.get(key) == w.get(key), (row, key)
        assert abs(float(g["final_acc"]) - float(w["final_acc"])) <= ACC_ATOL, row
