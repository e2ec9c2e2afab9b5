"""Models of the paper's FL experiments, and the LM tier's decoder models."""
from repro_torch.models.config import (
    INPUT_SHAPES,
    EncoderConfig,
    InputShape,
    MLAConfig,
    ModelConfig,
    MoEConfig,
)
from repro_torch.models.model import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    logits_from_hidden,
    loss_fn,
    param_count,
    params_from_numpy,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "EncoderConfig",
    "InputShape",
    "INPUT_SHAPES",
    "LM",
    "init_params",
    "params_from_numpy",
    "forward",
    "decode_step",
    "init_cache",
    "loss_fn",
    "logits_from_hidden",
    "param_count",
]
