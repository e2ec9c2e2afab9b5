# Copied from src/repro/configs/whisper_small.py.
"""whisper-small [audio] — encoder-decoder (arXiv:2212.04356).

12L (decoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865, plus a 12-layer
bidirectional encoder over 1500 stubbed conv-frontend frames. The
mel-spectrogram + conv feature extractor is a STUB per the brief:
``input_specs`` supplies (B, 1500, d_model) frame embeddings.

Simplifications recorded in DESIGN.md: RMSNorm instead of LayerNorm,
computed sinusoidal decoder positions instead of learned (whisper's decoder
positions are learned and capped at 448 — the assigned decode shapes exceed
that by design of the shape grid, so a computed encoding is used).
"""
from repro_torch.models.config import EncoderConfig, ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        pattern=(("attn", "mlp"),),
        qkv_bias=True,
        act="gelu",
        encoder=EncoderConfig(n_layers=12, n_frames=1500),
        frontend="audio",
        sliding_window=8192,
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )
