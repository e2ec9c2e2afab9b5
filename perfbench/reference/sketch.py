"""The SRP sketch's columns, worked out again from its hash.

Frozen copy of the hash in ``src/repro_torch/kernels/sketch/ref.py``:
S[k, j] = ±1/√d′, the sign the low bit of murmur3's fmix32 over
``k·K ^ j·J ^ seed·SEED`` (uint32 arithmetic). Here the hash runs in int32
tensors, whose products wrap modulo 2³² as uint32 ones do; an arithmetic
shift is masked to a logical one.

:class:`Signs` hashes S's signs once for a seed, a block of coordinates
at a time, and keeps them packed eight columns to a byte (d·d′/8 bytes:
12.4 GB at d = 1.54 B, d′ = 64), so that sketching each further row reads
bytes and hashes nothing; no (d, d′) float matrix is ever made.
"""
from __future__ import annotations

import numpy as np
import torch

C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
K_SALT = 0x9E3779B1
J_SALT = 0x7FEB352D
SEED_SALT = 0x165667B1
MASK = 0xFFFFFFFF
#: coordinates a block: the (|J|, BLOCK) int32 hashes of 64 columns take 512 MB
BLOCK = 1 << 21


def _i32(x: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    x &= MASK
    return x - (1 << 32) if x >= (1 << 31) else x


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int32 tensors holding uint32 bits, in place."""
    h ^= (h >> 16) & 0xFFFF
    h *= _i32(C1)
    h ^= (h >> 13) & 0x7FFFF
    h *= _i32(C2)
    h ^= (h >> 16) & 0xFFFF
    return h


def scale(d_prime: int) -> float:
    return float(np.float32(1.0 / np.sqrt(float(d_prime))))


class Signs:
    """The signs of S's columns ``cols`` (the bit 1 for +), packed: byte b
    of coordinate k holds columns 8b … 8b + 7."""

    def __init__(self, d: int, cols, seed: int, d_prime: int, device):
        if d >= 1 << 31:
            raise ValueError("the int32 hash covers d < 2**31 coordinates")
        self.d, self.n_cols, self.d_prime = int(d), len(cols), int(d_prime)
        seed_term = (int(seed) * SEED_SALT) & MASK
        salts = torch.tensor([_i32(((int(j) * J_SALT) & MASK) ^ seed_term) for j in cols],
                             dtype=torch.int32, device=device)[:, None]
        n_bytes = -(-self.n_cols // 8)
        self.shifts = torch.arange(8, dtype=torch.uint8, device=device)[None, :, None]
        self.packed = torch.zeros((n_bytes, self.d), dtype=torch.uint8, device=device)
        for k0 in range(0, self.d, BLOCK):
            n = min(BLOCK, self.d - k0)
            kk = torch.arange(k0, k0 + n, dtype=torch.int32, device=device) * _i32(K_SALT)
            bit = torch.zeros((n_bytes * 8, n), dtype=torch.uint8, device=device)
            bit[:self.n_cols] = mix32(kk[None, :] ^ salts) & 1
            self.packed[:, k0:k0 + n] = (bit.view(n_bytes, 8, n) << self.shifts).sum(1, dtype=torch.uint8)

    def columns(self, u: torch.Tensor) -> torch.Tensor:
        """u (d,) f32 -> (|cols|,) f64: u · S[:, j] for each column j."""
        if u.numel() != self.d:
            raise ValueError(f"a row of {u.numel()} coordinates for signs of {self.d}")
        out = torch.zeros(self.n_cols, dtype=torch.float64, device=u.device)
        for k0 in range(0, self.d, BLOCK):
            n = min(BLOCK, self.d - k0)
            bytes_ = self.packed[:, None, k0:k0 + n]
            bit = ((bytes_ >> self.shifts) & 1).bool().reshape(-1, n)[:self.n_cols]
            seg = u[k0:k0 + n][None, :]
            out += torch.where(bit, seg, -seg).sum(1, dtype=torch.float64)
        return out * scale(self.d_prime)
