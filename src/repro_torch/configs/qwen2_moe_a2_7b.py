# Copied from src/repro/configs/qwen2_moe_a2_7b.py.
"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed, top-4 (hf:Qwen/Qwen1.5-MoE-A2.7B).

24L d_model=2048 16H (kv=16) d_ff_expert=1408 vocab=151936. Every layer is
MoE (Qwen1.5-MoE layout); shared experts are always-on.
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        pattern=(("attn", "moe"),),
        qkv_bias=True,
        rope_theta=1e6,
        sliding_window=8192,
        moe=MoEConfig(
            n_routed=60,
            n_shared=4,
            top_k=4,
            d_ff_expert=1408,
            group_size=2048,
            capacity_factor=1.25,
        ),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )
