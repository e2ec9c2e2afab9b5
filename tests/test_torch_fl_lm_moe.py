"""The port's federated LM on the reduced MoE models against the JAX
package's: whole ``run_federated_lm`` runs from the reference's parameters
(``tests/_torch_fl_lm.py``; its tolerances)."""
import pytest

from _torch_fl_lm import assert_run_matches_the_reference
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

RUNS = {f"deepseek-v2-lite-16b[{name}]": ("deepseek-v2-lite-16b", name)
        for name in ("md", "algorithm2")}
RUNS["qwen2-moe-a2.7b[md]"] = ("qwen2-moe-a2.7b", "md")


@pytest.mark.parametrize("run", RUNS)
def test_run_federated_lm_matches_the_reference(run, monkeypatch):
    """The reduced deepseek-v2-lite at d_model 64 and vocab 256 (MLA, a
    dense first block and a MoE under the local steps' gradients) under md
    and Algorithm 2; the reduced qwen2-moe at the same widths under md."""
    assert_run_matches_the_reference(*RUNS[run], monkeypatch)
