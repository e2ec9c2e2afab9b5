# Copied from src/repro/models/config.py.
"""Model configuration for the assigned architecture zoo.

One :class:`ModelConfig` describes any of the 10 assigned architectures.
A model is a stack of *blocks*; each block is a ``(mixer, ffn)`` pair.
The stack is ``first_blocks`` (unstacked prefix, e.g. DeepSeek's dense
layer 0) + ``pattern`` repeated ``n_repeats`` times (lax.scan over stacked
params) + ``tail_blocks`` (unstacked remainder, e.g. RecurrentGemma's
38 = 12*3 + 2).

Mixer kinds:  attn | local | mla | mlstm | slstm | rglru | bidir (encoder)
FFN kinds:    mlp | moe | none
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BlockSpec = tuple[str, str]  # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff_expert: int
    # GShard-style capacity dispatch: tokens per group and capacity factor
    group_size: int = 2048
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # decode path: "naive" re-expands the compressed cache each step;
    # "absorbed" folds W_UK into the query (beyond-paper §Perf variant)
    decode_mode: str = "naive"


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consuming stubbed conv-frontend embeddings."""

    n_layers: int = 12
    n_frames: int = 1500  # 30 s of audio at 10 ms hop / 2 (conv stride)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- stack structure ---
    pattern: tuple[BlockSpec, ...] = (("attn", "mlp"),)
    first_blocks: tuple[BlockSpec, ...] = ()
    tail_blocks: tuple[BlockSpec, ...] = ()
    # --- attention options ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False  # Qwen2-VL 3-section rotary
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w halves of head_dim
    sliding_window: int = 4096  # for "local" mixers & long-context dense decode
    logit_softcap: float = 0.0
    # --- recurrent options ---
    rglru_conv_width: int = 4
    lru_width: int = 0  # 0 -> d_model
    mlstm_chunk: int = 0  # >0: chunkwise-recurrent mLSTM (O(S·chunk), §Perf)
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.333334
    # --- other substructure ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None  # 'audio' | 'vision' (stubbed embeddings)
    n_vision_tokens: int = 256  # VLM: prefix patch-embedding slots
    # --- numerics ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"
    dtype: str = "bfloat16"  # activation compute dtype
    param_dtype: str = "float32"
    # memory knobs (exercised by §Perf; defaults = paper-faithful baseline)
    attn_block_q: int = 0  # 0 -> vanilla attention; >0 -> blockwise online-softmax
    remat: bool = True
    # Megatron-SP style sequence-parallel residual stream: the hidden states
    # between blocks are sharded over ("model", seq) so per-layer TP traffic
    # becomes all-gather/reduce-scatter pairs on bf16 activations instead of
    # f32 all-reduces of activation gradients (§Perf collective lever).
    seq_parallel_residual: bool = False
    # lax.scan over layer repeats (runtime default). The dry-run unrolls
    # (scan_layers=False): XLA's cost_analysis counts while-loop bodies ONCE,
    # so scanned-layer FLOPs/bytes/collectives would be undercounted by
    # n_repeats× (verified empirically; see EXPERIMENTS.md §Dry-run notes).
    scan_layers: bool = True
    fused_ce: bool = False  # chunked cross-entropy (never materialize full logits)
    source: str = ""  # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.first_blocks) - len(self.tail_blocks)
        if body % len(self.pattern):
            raise ValueError(
                f"{self.name}: body layers {body} not divisible by pattern "
                f"period {len(self.pattern)}"
            )
        return body // len(self.pattern)

    @property
    def all_blocks(self) -> tuple[BlockSpec, ...]:
        return self.first_blocks + self.pattern * self.n_repeats + self.tail_blocks

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires n_heads % n_kv_heads == 0"
        assert len(self.all_blocks) == self.n_layers
        for mixer, ffn in self.pattern + self.first_blocks + self.tail_blocks:
            assert mixer in ("attn", "local", "mla", "mlstm", "slstm", "rglru", "bidir"), mixer
            assert ffn in ("mlp", "moe", "none"), ffn
        if any(f == "moe" for _, f in self.all_blocks):
            assert self.moe is not None
        if any(m == "mla" for m, _ in self.all_blocks):
            assert self.mla is not None


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
