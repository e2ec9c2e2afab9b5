# Copied from src/repro/configs/deepseek_v2_lite_16b.py.
"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE (arXiv:2405.04434).

27L d_model=2048 16H d_ff_expert=1408 vocab=102400. MLA kv_lora_rank=512
(+64 rotary dims -> 576-dim compressed cache). Layer 0 is a dense MLP
(d_ff 10944 per the model card); layers 1..26 are MoE with 2 shared +
64 routed experts, top-6.

NOTE: the assignment header says "MoE 64e top-6" while its bracket note
says "160 routed" (the full DeepSeek-V2). We follow the header — 64 routed —
and record the discrepancy here and in DESIGN.md §Arch-applicability.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,  # dense layer 0 (model card); experts use moe.d_ff_expert
        vocab_size=102400,
        first_blocks=(("mla", "mlp"),),
        pattern=(("mla", "moe"),),
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_routed=64,
            n_shared=2,
            top_k=6,
            d_ff_expert=1408,
            group_size=2048,
            capacity_factor=1.25,
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            rope_head_dim=64,
            nope_head_dim=128,
            v_head_dim=128,
            decode_mode="naive",  # paper-faithful; 'absorbed' is the §Perf variant
        ),
        source="arXiv:2405.04434",
    )
