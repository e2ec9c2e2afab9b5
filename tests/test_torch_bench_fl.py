"""The port's ``bench_fl_collectives``, ``bench_sampler_cost``,
``bench_round_engine``, ``bench_kernels`` and ``bench_store_scale`` against
the repo's JAX modules (``benchmarks/``), each at ``--smoke`` (or as it is,
where the reference has no smoke mode) with ``--device cpu``: the same row
names in the same order (``bench_kernels`` through its ``ROW_MAP``) and the
deterministic fields equal. Also: every ported ``bench_*`` module defaults
to the card and raises without it, and ``chip_smoke.py``'s list of the
full-mode rows is the reference's."""
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch.benchmarks import (
    bench_async_planner,
    bench_fl_collectives,
    bench_kernels,
    bench_round_engine,
    bench_sampler_cost,
    bench_scheduler,
    bench_service_churn,
    bench_store_scale,
)
from repro_torch.benchmarks import common as port_common

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference modules live in the repo's benchmarks/
    sys.path.insert(0, str(ROOT))
from benchmarks import bench_async_planner as ref_async  # noqa: E402
from benchmarks import bench_fl_collectives as ref_fl  # noqa: E402
from benchmarks import bench_kernels as ref_kernels  # noqa: E402
from benchmarks import bench_round_engine as ref_engine  # noqa: E402
from benchmarks import bench_sampler_cost as ref_sampler  # noqa: E402
from benchmarks import bench_scheduler as ref_scheduler  # noqa: E402
from benchmarks import bench_service_churn as ref_churn  # noqa: E402
from benchmarks import bench_store_scale as ref_store  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402
from repro_torch.testing import pin_cpu_threads  # noqa: E402

pin_cpu_threads()

PORTED = {
    "bench_fl_collectives": bench_fl_collectives,
    "bench_sampler_cost": bench_sampler_cost,
    "bench_round_engine": bench_round_engine,
    "bench_kernels": bench_kernels,
    "bench_store_scale": bench_store_scale,
    "bench_async_planner": bench_async_planner,
    "bench_service_churn": bench_service_churn,
    "bench_scheduler": bench_scheduler,
}


def rows(text: str) -> list[tuple[str, float, str]]:
    """(name, µs, derived) of a module's ``name,us,derived`` lines."""
    out = []
    for line in text.splitlines():
        name, us, derived = line.split(",", 2)
        out.append((name, float(us), derived))
    return out


def fields(derived: str) -> dict:
    """``a=1;b=x y`` -> {"a": "1", "b": "x y"} (parts without "=" dropped)."""
    return dict(part.split("=", 1) for part in derived.split(";") if "=" in part)


def run_pair(capsys, ref_main, port_main, argv):
    """The reference's rows and the port's (``--device cpu``) for ``argv``."""
    ref_main(argv)
    want = rows(capsys.readouterr().out)
    port_main(argv + ["--device", "cpu"])
    got = rows(capsys.readouterr().out)
    return got, want


def test_fl_collectives_rows_equal_reference_letter_for_letter(capsys):
    ref_fl.main()
    want = rows(capsys.readouterr().out)
    bench_fl_collectives.main(["--device", "cpu"])
    got = rows(capsys.readouterr().out)
    assert got == want
    assert ("fl_comm/per_client_round_bytes", 0.0, "bytes=17280") in got
    assert got[1][2] == "bytes=1728000;ratio=100x"


def test_sampler_cost_rows_equal_reference(capsys):
    got, want = run_pair(capsys, ref_sampler.main, bench_sampler_cost.main, ["--smoke"])
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    assert sum(r[0].startswith("sampler_cost/draw/") for r in got) == 9
    assert all(us > 0 for _, us, _ in got)


def test_round_engine_rows_equal_reference(capsys):
    got, want = run_pair(capsys, ref_engine.main, bench_round_engine.main, ["--smoke"])
    assert [r[0] for r in got] == [r[0] for r in want] == [
        "round_engine/m=5/compat", "round_engine/m=5/batched"]
    for name, us, derived in got:
        assert us > 0 and derived.startswith("us per round"), name
        assert fields(derived)["launches"] == "0", name  # the plain version, no kernel


def test_kernels_rows_map_to_reference(capsys):
    ref_kernels.main()
    want = rows(capsys.readouterr().out)
    bench_kernels.main(["--device", "cpu"])
    got = rows(capsys.readouterr().out)
    mapped = [name for name, _, _ in got if name not in bench_kernels.EXTRA_ROWS]
    assert mapped == [bench_kernels.ROW_MAP[name] for name, _, _ in want]
    assert [name for name, _, _ in got] == [
        "kernels/similarity_gram_plain", "kernels/similarity_cuda", "kernels/aggregate_plain",
        "kernels/aggregate_cuda", "kernels/flash_attention_plain", "kernels/flash_attention_cuda"]
    by_name = {name: derived for name, _, derived in got}
    for ref_name, ref_us, ref_derived in want:
        port = fields(by_name[bench_kernels.ROW_MAP[ref_name]])
        for key, value in fields(ref_derived).items():  # the shapes and FLOP / byte counts
            if key != "mode":
                assert port[key] == value, (ref_name, key)
    for name in ("kernels/similarity_cuda", "kernels/aggregate_cuda",
                 "kernels/flash_attention_cuda"):
        f = fields(by_name[name])
        assert float(f["max_abs_err"]) == 0.0  # the wrapper ran its plain version
        assert float(f["h100_bound_ms"]) > 0 and "event_ms" not in f
    # the bounds of the shapes: the Gram's triangle, 44 MB, the causal triangle
    assert fields(by_name["kernels/similarity_cuda"])["h100_bound_ms"] == "0.000311"
    assert fields(by_name["kernels/aggregate_cuda"])["h100_bound_ms"] == "0.013134"
    assert fields(by_name["kernels/flash_attention_cuda"])["h100_bound_ms"] == "0.001002"


def test_store_scale_rows_equal_reference(capsys):
    got, want = run_pair(capsys, ref_store.main, bench_store_scale.main, ["--smoke"])
    assert [r[0] for r in got] == [r[0] for r in want]
    assert bench_store_scale.EXACT_BYTE_CAP == ref_store.EXACT_BYTE_CAP == 1 << 30
    assert bench_store_scale.D_PRIME == ref_store.D_PRIME
    for (name, us, derived), (_, _, ref_derived) in zip(got, want):
        assert us > 0, name
        g, w = fields(derived), fields(ref_derived)
        for key in ("bytes", "ratio"):
            assert g.get(key) == w.get(key), (name, key)
        if name.startswith("store/") and name.endswith("srp64"):
            assert g["scatters"] == "2" and g["srp_launches"] == "0"  # the plain version


@pytest.mark.parametrize("name", sorted(PORTED))
def test_bench_main_defaults_to_cuda_and_raises_without_it(name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORTED[name].main([])


def _smoke():
    """``chip_smoke.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _reference_full_rows(monkeypatch, capsys) -> dict:
    """Each reference module's full-mode row names (``bench_async_planner``
    with ``--drift``), its timed work and runs stubbed out: the names are a
    function of the sizes alone; the churn and scheduler rows are their
    scenario and policy names."""
    stub = lambda fn, *a, **kw: (0.0, np.zeros(1))  # noqa: E731
    store = types.SimpleNamespace(nbytes=4, update=lambda *a: None, snapshot=lambda: None)
    for mod in (ref_sampler, ref_kernels, ref_common):
        monkeypatch.setattr(mod, "timed", stub)
    monkeypatch.setattr(ref_engine, "_rounds_per_sec", lambda *a, **kw: 1.0)
    monkeypatch.setattr(ref_engine, "_dataset", lambda **kw: None)
    monkeypatch.setattr(ref_store, "_store", lambda *a, **kw: store)
    monkeypatch.setattr(ref_store, "_scatter_us", lambda *a, **kw: 0.0)
    monkeypatch.setattr(ref_store, "_rebuild_us", lambda *a, **kw: 0.0)
    monkeypatch.setattr(ref_async, "_mean_round_time", lambda *a, **kw: (1.0, 0.0, 0, 0.0))
    monkeypatch.setattr(ref_async, "_random_clients", lambda **kw: None)
    monkeypatch.setattr(ref_async, "_register_dataset", lambda: None)  # registers no stub
    out = {}
    for name, main in (("bench_fl_collectives", lambda: ref_fl.main()),
                       ("bench_sampler_cost", lambda: ref_sampler.main([])),
                       ("bench_round_engine", lambda: ref_engine.main([])),
                       ("bench_kernels", lambda: ref_kernels.main()),
                       ("bench_store_scale", lambda: ref_store.main([])),
                       ("bench_async_planner", lambda: ref_async.main(["--drift"]))):
        main()
        out[name] = [r[0] for r in rows(capsys.readouterr().out)]
    out["bench_service_churn"] = [f"service_churn/{label}" for label, _ in ref_churn.SCENARIOS]
    out["bench_scheduler"] = [f"scheduler/{label}" for label, _ in ref_scheduler.POLICIES]
    return out


def test_smoke_bench_rows_are_the_references_full_mode_rows(monkeypatch, capsys):
    smoke = _smoke()
    want = _reference_full_rows(monkeypatch, capsys)
    want["bench_kernels"] = [bench_kernels.ROW_MAP[n] for n in want["bench_kernels"]]
    got = {name: [n for n in names if n not in bench_kernels.EXTRA_ROWS]
           for name, names in smoke.BENCH_ROWS.items()}
    assert list(got) == list(PORTED) == list(smoke.BENCH_ARGS)
    assert got == want
    assert [n for n in smoke.BENCH_ROWS["bench_kernels"] if n in bench_kernels.EXTRA_ROWS] == list(
        bench_kernels.EXTRA_ROWS)


def test_common_timed_waits_for_the_device(monkeypatch):
    """``timed`` synchronises after the warm-up and after every timed call
    on a CUDA device, and never for the CPU."""
    calls = []
    monkeypatch.setattr(port_common.torch.cuda, "synchronize", lambda d=None: calls.append("sync"))
    port_common.timed(lambda: calls.append("call"), repeats=2, warmup=1, device="cuda")
    assert calls == ["call", "sync", "call", "sync", "call", "sync"]
    calls.clear()
    port_common.timed(lambda: calls.append("call"), repeats=2, warmup=1, device="cpu")
    assert calls == ["call"] * 3


def _kernel_rows(smoke):
    """bench_kernels rows as the card prints them, every gate met."""
    fields = {"kernels/similarity_cuda": "gram_err=3.6e-07 of |g_i||g_j|;max_abs_err=1.2e-07",
              "kernels/aggregate_cuda": "max_abs_err=2.9e-06",
              "kernels/flash_attention_cuda": "max_abs_err=2.4e-07"}
    return [[name, 50.0, f"h100_bound_ms=0.013134;event_ms=0.016862;{fields[name]}"
             if name in fields else "n=1"] for name in smoke.BENCH_ROWS["bench_kernels"]]


LAUNCHES = {"gram": 1, "l1": 0, "aggregate": 1, "srp": 0, "flash_attention": 1}


@pytest.mark.parametrize("wrong", [None, "name", "time", "host_below_bound", "events_below_bound",
                                   "gram_err", "flash_err", "no_launch"])
def test_bench_check_rejects_wrong_kernel_rows(wrong):
    """``chip_smoke._bench_check`` on ``bench_kernels``' rows: each gate
    fails the run when its row is wrong, and passes rows that meet them."""
    smoke = _smoke()
    rows, launches = _kernel_rows(smoke), dict(LAUNCHES)
    by = {r[0]: r for r in rows}
    if wrong == "name":
        rows[0][0] = "kernels/similarity_gram_ref_cpu"
    elif wrong == "time":
        by["kernels/aggregate_plain"][1] = float("nan")
    elif wrong == "host_below_bound":
        by["kernels/aggregate_cuda"][1] = 10.0  # 0.010 ms < 0.013134: the launch alone
    elif wrong == "events_below_bound":
        by["kernels/aggregate_cuda"][2] = by["kernels/aggregate_cuda"][2].replace(
            "event_ms=0.016862", "event_ms=0.004")
    elif wrong == "gram_err":
        by["kernels/similarity_cuda"][2] = by["kernels/similarity_cuda"][2].replace(
            "gram_err=3.6e-07", "gram_err=2.0e-05")
    elif wrong == "flash_err":
        by["kernels/flash_attention_cuda"][2] = by["kernels/flash_attention_cuda"][2].replace(
            "2.4e-07", "3.0e-05")
    elif wrong == "no_launch":
        launches["flash_attention"] = 0
    if wrong is None:
        smoke._bench_check("bench_kernels", rows, launches)
    else:
        with pytest.raises(RuntimeError, match="bench:"):
            smoke._bench_check("bench_kernels", rows, launches)


INFEASIBLE = {"store/n=10000/d=100000/exact", "store/n=100000/d=10000/exact",
              "rebuild/n=100000/d=10000/exact"}


def _derived(smoke, mod: str, name: str) -> str:
    """A derived column of ``mod``'s row ``name`` that meets the gates."""
    if mod == "bench_scheduler":
        return "n_late=0;parity=bit-identical" if name == "scheduler/sync" else "n_late=0"
    if mod == "bench_round_engine":
        return f"us per round;launches={smoke.BENCH_ROUNDS}"
    if name in INFEASIBLE:
        return "infeasible: over the cap"
    if name.startswith("store/") and name.endswith("srp64"):
        return "scatters=3;srp_launches=3"
    return "bytes=1"


@pytest.mark.parametrize("wrong", [None, "bench_scheduler", "bench_round_engine",
                                   "bench_store_scale"])
def test_bench_check_rejects_wrong_parity_and_launch_rows(wrong):
    """The scheduler row without its parity, a round engine row with a B2
    launch short, the store with an SRP launch short: each fails the run."""
    smoke = _smoke()
    # 5 store cells of 3 sketched scatters, and one scatter a sketched rebuild cell
    launches = {"bench_scheduler": {"gram": 1, "aggregate": 1},
                "bench_round_engine": {"aggregate": 6 * smoke.BENCH_ROUNDS},
                "bench_store_scale": {"srp": 5 * 3 + 2}}
    for mod, counts in launches.items():
        rows = [[n, 1.0, _derived(smoke, mod, n)] for n in smoke.BENCH_ROWS[mod]]
        if mod != wrong:
            smoke._bench_check(mod, rows, counts)
            continue
        if mod == "bench_scheduler":
            rows[0][2] = "n_late=0"
        elif mod == "bench_round_engine":
            rows[-1][2] = f"us per round;launches={smoke.BENCH_ROUNDS - 1}"
        else:
            counts = {"srp": counts["srp"] - 1}
        with pytest.raises(RuntimeError, match="bench:"):
            smoke._bench_check(mod, rows, counts)
