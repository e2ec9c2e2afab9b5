"""The port's copies of the config modules equal the reference's.

``get_config(name, reduced=r)`` is compared field by field through
``dataclasses.asdict`` for every architecture and both ``r``; the port's
parameter count at full width (qwen2-1.5b, qwen3-0.6b, llama3.2-3b, the
recurrent recurrentgemma-9b and xlstm-125m, whisper-small with its encoder
and qwen2-vl-2b), built on the ``meta`` device,
equals the reference's from ``jax.eval_shape`` (neither allocates).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.models import INPUT_SHAPES as REF_INPUT_SHAPES
from repro.models import model as ref_model
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import INPUT_SHAPES
from repro_torch.models import model as mdl
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


def test_arch_names_and_input_shapes_equal_the_reference():
    assert ARCH_NAMES == REF_ARCH_NAMES
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_INPUT_SHAPES.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", REF_ARCH_NAMES)
def test_get_config_equals_the_reference(name, reduced):
    port, ref = get_config(name, reduced=reduced), ref_get_config(name, reduced=reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.resolved_head_dim, port.n_repeats, port.all_blocks) == (
        ref.resolved_head_dim, ref.n_repeats, ref.all_blocks)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-0.6b", "llama3.2-3b", "recurrentgemma-9b",
                                  "xlstm-125m", "whisper-small", "qwen2-vl-2b"])
def test_full_width_param_count_equals_the_reference(name):
    cfg = ref_get_config(name)
    shapes = jax.eval_shape(lambda key: ref_model.init_params(cfg, key), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    params = mdl.init_params(get_config(name), device="meta")
    assert all(p.device.type == "meta" for p in params.parameters())
    assert mdl.param_count(params) == want
    if name == "qwen2-1.5b":
        assert want == 1_543_714_304  # ≈1.54 B: 6.2 GB in f32, one card
    if name == "recurrentgemma-9b":
        assert want == 9_396_408_320  # 35.00 GiB in f32: serves on one card
    if name == "xlstm-125m":
        assert want == 143_345_712
    if name == "whisper-small":
        assert want == 294_766_848  # its 12 encoder blocks and cross-attention included
    if name == "qwen2-vl-2b":
        assert want == 1_543_714_304  # qwen2-1.5b's backbone: M-RoPE adds no parameter
