# Copied from src/repro/configs/__init__.py.
"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    llama3_2_3b,
    qwen2_1_5b,
    qwen2_5_32b,
    qwen2_moe_a2_7b,
    qwen2_vl_2b,
    qwen3_0_6b,
    recurrentgemma_9b,
    whisper_small,
    xlstm_125m,
)
from repro_torch.configs.reduced import make_reduced
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "xlstm-125m": xlstm_125m,
    "qwen3-0.6b": qwen3_0_6b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "qwen2-1.5b": qwen2_1_5b,
    "qwen2.5-32b": qwen2_5_32b,
    "llama3.2-3b": llama3_2_3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "whisper-small": whisper_small,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    cfg = _MODULES[name].build()
    cfg.validate()
    return make_reduced(cfg) if reduced else cfg


__all__ = [
    "get_config",
    "make_reduced",
    "ARCH_NAMES",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
]
