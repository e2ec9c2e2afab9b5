"""The port's examples (``examples/torch_*.py``) against the repo's JAX
examples: the same table, row for row, with numbers within 1e-4 (the
reference's MLP initialisation carried across where a model trains)."""
import importlib.util
import re
import sys
from pathlib import Path

import pytest

import repro_torch.models.simple as port_simple
from repro.models.simple import init_mlp as ref_init_mlp
from repro_torch.models.simple import params_from_numpy
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?")
ATOL = 1e-4


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carried_init(dims, seed=0, device="cuda"):
    return params_from_numpy(ref_init_mlp(tuple(dims), seed=seed), device=device)


def _same_table(got: str, want: str) -> None:
    """Equal lines once numbers are masked; each number within ATOL (a
    number printed to d decimals may differ by one unit in its last place)."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines)
    for g, w in zip(g_lines, w_lines):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            places = len(b.split(".")[1].split("e")[0])
            assert abs(float(a) - float(b)) <= max(ATOL, 10.0**-places * 1.01), (g, w)


def _outputs(name: str, argv: list, capsys, monkeypatch) -> tuple[str, str]:
    ref, port = _load(name), _load(f"torch_{name}")
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    ref.main()
    want = capsys.readouterr().out
    port.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out, want


def test_quickstart_prints_the_reference_table(capsys, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    got, want = _outputs("quickstart", [], capsys, monkeypatch)
    assert "classes/round" in got and "Clustered / Algorithm 2" in got
    _same_table(got, want)


def test_dirichlet_heterogeneity_prints_the_reference_table(capsys, monkeypatch):
    monkeypatch.setattr(port_simple, "init_mlp", _carried_init)
    got, want = _outputs("dirichlet_heterogeneity", ["--rounds", "6", "--verbose"], capsys,
                         monkeypatch)
    assert got.count("    round") == 12 and "Clustered-Alg2" in got
    _same_table(got, want)


@pytest.mark.parametrize("argv", [[], ["--sizes", "50", "80", "120", "400", "90", "700", "300",
                                       "30", "--m", "3"]])
def test_sampling_statistics_prints_the_reference_table(argv, capsys, monkeypatch):
    got, want = _outputs("sampling_statistics", argv, capsys, monkeypatch)
    assert "Algorithm 2 (similarity urns" in got
    assert got == want  # no training: the plans and statistics are printed identically


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_dirichlet_heterogeneity",
                                  "torch_sampling_statistics"])
def test_examples_default_to_cuda_and_raise_without_it(name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])
