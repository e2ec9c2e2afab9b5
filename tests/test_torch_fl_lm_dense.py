"""The port's federated LM on the narrow reduced qwen3-0.6b against the
JAX package's, under each sampler: whole ``run_federated_lm`` runs from the
reference's parameters (``tests/_torch_fl_lm.py``; its tolerances)."""
import pytest

from _torch_fl_lm import SAMPLERS, assert_run_matches_the_reference
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

RUNS = {name: ("qwen3-0.6b", name) for name in SAMPLERS}


@pytest.mark.parametrize("run", RUNS)
def test_run_federated_lm_matches_the_reference(run, monkeypatch):
    """qwen3's narrow reduced config under md, Algorithm 1, Algorithm 2 and
    Algorithm 2 on the SRP-sketched store."""
    assert_run_matches_the_reference(*RUNS[run], monkeypatch)
