# Copied from src/repro/data/tokens.py.
"""Synthetic LM token pipeline for the production tier.

Deterministic on-the-fly batch synthesis (no corpus offline): a hash-mixed
counter stream mapped into the vocab, with next-token structure injected so
the loss actually decreases (target = affine function of current token mod
vocab). Enough signal for end-to-end driver runs and overfit tests; shapes
and dtypes match a real pipeline exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenBatch:
    tokens: np.ndarray  # (B, S) int32 inputs
    targets: np.ndarray  # (B, S) int32 next tokens
    # loss mask left implicit (all ones) — synthetic stream has no padding


class TokenPipeline:
    def __init__(self, vocab_size: int, batch_size: int, seq_len: int, seed: int = 0):
        self.vocab_size = int(vocab_size)
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self._rng = np.random.default_rng(seed)

    def next_batch(self) -> TokenBatch:
        b, s, v = self.batch_size, self.seq_len, self.vocab_size
        base = self._rng.integers(0, v, size=(b, 1), dtype=np.int64)
        pos = np.arange(s, dtype=np.int64)[None, :]
        # structured stream: token_t = (base + 31*t) mod v -> learnable
        toks = (base + 31 * pos) % v
        tgts = (toks * 1 + 31) % v  # next token in the same progression
        return TokenBatch(toks.astype(np.int32), tgts.astype(np.int32))

    def __iter__(self):
        while True:
            yield self.next_batch()
