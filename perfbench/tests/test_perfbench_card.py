"""Card tests of the benchmark's comparison: at tiny widths, the port's
round on the card (B2, B3, B4's f32 route and the sampler's device path)
is correct
under each cell's limits, and the fp8 control put in its place is not.

Run them on a machine with an NVIDIA GPU:
``python3 -m pytest -q perfbench/tests/test_perfbench_card.py``.
At a cell's own size the control runs as ``python3 -m perfbench.control``.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.testing import pin_cpu_threads

from perfbench import control, spec
from perfbench.reference import federated
from perfbench.tests._tiny import run_on, tiny_cell

pin_cpu_threads()

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_round_on_the_card_is_correct(name):
    ok, numbers = run_on(tiny_cell(name), _card())
    assert ok, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_on_the_card_fails(name):
    dev = _card()
    cell = tiny_cell(name)
    traffic, a = cell["traffic_file"], spec.arch(cell["config_file"])
    rounds = control.schedule(traffic, 5)
    kw = dict(device=dev, signs=federated.signs_for(a, traffic, 5, dev))
    ref = federated.run(a, traffic, 5, rounds, **kw)
    numbers = control.numbers(ref, federated.run(a, traffic, 5, rounds, quant="fp8", **kw), traffic)
    judged = control.judged(numbers, cell["limits"])
    assert not judged["correct"], judged
