# Copied from src/repro/configs/qwen2_5_32b.py.
"""qwen2.5-32b [dense] — GQA with QKV bias (hf:Qwen/Qwen2.5 family).

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064. The memory-pressure
stress case of the zoo (params must be FSDP-sharded to fit).
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        pattern=(("attn", "mlp"),),
        qkv_bias=True,
        rope_theta=1e6,
        sliding_window=8192,
        source="hf:Qwen/Qwen2.5-0.5B",
    )
