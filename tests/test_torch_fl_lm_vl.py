"""The port's federated LM on the reduced qwen2-vl-2b against the JAX
package's: whole ``run_federated_lm`` runs from the reference's parameters
(``tests/_torch_fl_lm.py``; its tolerances). The local step calls
``loss_fn`` on tokens alone, in both packages, so qwen2-vl trains as text:
M-RoPE with t = h = w and no vision embeddings. The flat vectors of the
reduced config are bit-equal to the reference's ``flatten_params``."""
import numpy as np
import pytest
import torch

from _torch_fl_lm import assert_run_matches_the_reference, configs, ref_params
from repro.fl.aggregation import flatten_params as ref_flatten
from repro_torch.models import model as mdl
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCH = "qwen2-vl-2b"
RUNS = {f"{ARCH}[{name}]": (ARCH, name) for name in ("md", "algorithm2")}


def test_flatten_params_of_the_vlm_is_bit_equal_to_the_reference():
    _, cfg = configs(ARCH)
    tree = ref_params(ARCH)
    got = mdl.flatten_lm(mdl.params_from_numpy(cfg, tree, device="cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_flatten(tree)))


@pytest.mark.parametrize("run", RUNS)
def test_run_federated_lm_matches_the_reference(run, monkeypatch):
    """The narrow reduced qwen2-vl (QKV biases, M-RoPE sections of the
    reduced head dim) under md and Algorithm 2."""
    assert_run_matches_the_reference(*RUNS[run], monkeypatch)
