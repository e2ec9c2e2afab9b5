"""The port's federated LM on the reduced xlstm-125m against the JAX
package's: whole ``run_federated_lm`` runs from the reference's parameters
(``tests/_torch_fl_lm.py``; its tolerances)."""
import pytest

from _torch_fl_lm import assert_run_matches_the_reference
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

RUNS = {f"xlstm-125m[{name}]": ("xlstm-125m", name) for name in ("md", "algorithm2")}


@pytest.mark.parametrize("run", RUNS)
def test_run_federated_lm_matches_the_reference(run, monkeypatch):
    """The narrow reduced xLSTM (an mLSTM and an sLSTM block, no FFN, no
    rotary angles) under md and Algorithm 2."""
    assert_run_matches_the_reference(*RUNS[run], monkeypatch)
