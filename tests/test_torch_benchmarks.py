"""The port's paper runners against the repo's JAX runners: the same rows."""
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.models.simple as port_simple
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.benchmarks import fig1_controlled, fig2_dirichlet, table_variance
from repro_torch.models.simple import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the reference runners live in the repo's benchmarks/
    sys.path.insert(0, str(ROOT))
from benchmarks import fig1_controlled as ref_fig1  # noqa: E402
from benchmarks import fig2_dirichlet as ref_fig2  # noqa: E402
from benchmarks import table_variance as ref_table  # noqa: E402
from repro_torch.testing import pin_cpu_threads  # noqa: E402

pin_cpu_threads()


def _rows(text: str) -> dict:
    """{row name: derived column} of a runner's ``name,us,derived`` lines."""
    rows = {}
    for line in text.splitlines():
        name, _us, derived = line.split(",", 2)
        rows[name] = derived
    return rows


def _stats(derived: str) -> dict:
    """``loss=0.1±0.2;seeds=2`` -> {"loss": (0.1, 0.2), "seeds": (2.0,)}."""
    return {k: tuple(float(x) for x in v.split("±"))
            for k, v in (kv.split("=") for kv in derived.split(";"))}


def test_table_variance_rows_equal_reference(capsys):
    ref_table.main()
    want = _rows(capsys.readouterr().out)
    table_variance.main(["--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    assert list(got) == list(want)
    assert got == want  # the same draws and plans: every statistic equal


def test_fig1_rows_match_reference_with_carried_parameters(capsys, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", lambda dims, seed=0, device="cuda": params_from_numpy(
        ref_init_mlp(tuple(dims), seed=seed), device=device))
    ref_fig1.main()
    want = _rows(capsys.readouterr().out)
    fig1_controlled.main(["--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    assert list(got) == list(want) == [f"fig1/sampler={s}" for s in
                                       ("md", "algorithm1", "algorithm2", "target")]
    for name in want:
        g, w = _stats(got[name]), _stats(want[name])
        assert list(g) == list(w)
        for key in ("classes", "clients", "seeds"):  # decided by the draws alone
            assert g[key] == w[key], (name, key)
        for key in ("loss", "acc"):  # printed to 4 decimals from values within 1e-4
            np.testing.assert_allclose(g[key], w[key], atol=2e-4, err_msg=f"{name} {key}")


def test_fig2_runs_on_the_cpu_and_prints_the_references_row_names(capsys):
    fig2_dirichlet.main(["--device", "cpu"])
    got = _rows(capsys.readouterr().out)
    want = [f"fig2/alpha={a}/name={s}" for a in ref_fig2.ALPHAS for s in ("md", "algorithm2")]
    want += [f"fig2/alpha={a}/clustered_gain" for a in ref_fig2.ALPHAS]
    assert list(got) == want
    for a in ref_fig2.ALPHAS:
        g = {s: _stats(got[f"fig2/alpha={a}/name={s}"])["loss"][0] for s in ("md", "algorithm2")}
        gain = float(re.fullmatch(r"loss_delta=(-?[0-9.]+)", got[f"fig2/alpha={a}/clustered_gain"])[1])
        assert abs(gain - (g["md"] - g["algorithm2"])) <= 2e-4


@pytest.mark.parametrize("runner", [fig1_controlled, fig2_dirichlet, table_variance])
def test_runners_default_to_cuda_and_raise_without_it(runner):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main([])
