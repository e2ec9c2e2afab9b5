# Copied from src/repro/configs/llama3_2_3b.py.
"""llama3.2-3b [dense] — small llama3 (hf:meta-llama/Llama-3.2-1B family).

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, rope theta 5e5.
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=128256,
        pattern=(("attn", "mlp"),),
        qkv_bias=False,
        rope_theta=500_000.0,
        sliding_window=8192,
        tie_embeddings=True,
        source="hf:meta-llama/Llama-3.2-1B",
    )
