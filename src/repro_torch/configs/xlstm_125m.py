# Copied from src/repro/configs/xlstm_125m.py.
"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304. d_ff=0: xLSTM blocks carry
their own up/down projections; there is no separate FFN. Blocks alternate
mLSTM (matrix memory, parallel-form training) and sLSTM (scalar memory,
sequential scan) 1:1.
"""
from repro_torch.models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        pattern=(("mlstm", "none"), ("slstm", "none")),
        mlstm_proj_factor=2.0,
        slstm_proj_factor=1.333334,
        tie_embeddings=True,
        source="arXiv:2405.04517",
    )
