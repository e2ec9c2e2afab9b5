# Copied from src/repro/configs/qwen2_1_5b.py.
"""qwen2-1.5b [dense] — GQA with QKV bias (arXiv:2407.10671).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        pattern=(("attn", "mlp"),),
        qkv_bias=True,
        rope_theta=1e6,
        sliding_window=8192,
        tie_embeddings=True,
        source="arXiv:2407.10671",
    )
