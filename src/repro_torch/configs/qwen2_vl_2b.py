# Copied from src/repro/configs/qwen2_vl_2b.py.
"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

qwen2-1.5b text backbone + 3-section rotary (t/h/w). The vision tower is a
STUB per the brief: ``input_specs`` supplies precomputed patch embeddings
(B, n_vision_tokens, d_model) that replace the leading token slots; text
tokens use t = h = w positions exactly as Qwen2-VL does.
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        pattern=(("attn", "mlp"),),
        qkv_bias=True,
        rope_theta=1e6,
        mrope=True,
        mrope_sections=(16, 24, 24),  # pairs per t/h/w stream (head_dim 128)
        sliding_window=8192,
        frontend="vision",
        n_vision_tokens=256,
        tie_embeddings=True,
        source="arXiv:2409.12191",
    )
