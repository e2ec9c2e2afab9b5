# Copied from src/repro/configs/recurrentgemma_9b.py.
"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 (arXiv:2402.19427).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. Griffin pattern:
(recurrent, recurrent, local-attention) repeating; 38 = 12*3 + 2 trailing
recurrent blocks. Local attention window 2048 with RoPE.
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")),
        tail_blocks=(("rglru", "mlp"), ("rglru", "mlp")),
        sliding_window=2048,
        rope_theta=10_000.0,
        act="gelu",
        tie_embeddings=True,
        source="arXiv:2402.19427",
    )
