# Copied from src/repro/configs/qwen3_0_6b.py.
"""qwen3-0.6b [dense] — qk-norm, GQA (hf:Qwen/Qwen3-8B family conventions).

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. Qwen3 uses an
explicit head_dim=128 (attention width 2048 != d_model), per-head RMS
qk-norm, no QKV bias, rope theta 1e6.
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        pattern=(("attn", "mlp"),),
        qk_norm=True,
        qkv_bias=False,
        rope_theta=1e6,
        sliding_window=8192,  # long_500k sliding-window decode variant
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B",
    )
