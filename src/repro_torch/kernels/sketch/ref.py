# Adapted from src/repro/kernels/sketch/ref.py: the hash in int64 tensors
# masked to 32 bits, the plain versions on torch tensors, and the numpy host
# references sketch_srp_reference and sketch_countsketch_reference.
"""The shared sign/bucket hash and the plain versions of the sketches.

``srp`` is y = X @ S with S a (d, d_prime) Rademacher matrix scaled by
1/sqrt(d_prime), never materialised: each (block_d, d_prime) block is
regenerated from a counter-based hash of (seed, coordinate k, output
column j). ``countsketch`` hashes each coordinate k to one bucket h(k)
with a sign s(k) and sums y[:, h(k)] += s(k) · X[:, k].

The hash is murmur3's fmix32 over uint32 arithmetic that wraps. Torch has
little uint32 arithmetic, so it runs here in int64 tensors masked to 32
bits after every step. A product of two 32-bit values would overflow
int64, so :func:`_mul32` multiplies in 16-bit halves whose terms stay
under 2**48. The bits equal the reference's ``np.uint32`` ones.

:func:`sketch_srp_plain` is what ``ops.srp_sketch`` computes for a CPU
tensor, and what ``chip_smoke.py`` holds the CUDA kernel against on the
card. :func:`sketch_srp_reference` and :func:`sketch_countsketch_reference`
are the reference's numpy host paths (each sketcher's ``.reference``): the
same hash's blocks and buckets, applied by numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

# murmur3 fmix32 constants and the stream salts of the reference
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_K_SALT = 0x9E3779B1
_J_SALT = 0x7FEB352D
_SEED_SALT = 0x165667B1
_MASK = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2**32 for int64 ``h`` in [0, 2**32) and a constant c < 2**32.

    h·c = lo·c + hi·c·2**16 with lo, hi the 16-bit halves of h; modulo
    2**32 only the low 16 bits of hi·c matter in the second term, so no
    intermediate exceeds 2**48 + 2**32.
    """
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer over int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def seed_term(seed: int) -> int:
    """The seed's 32-bit salt, as the CUDA kernel receives it."""
    return (int(seed) * _SEED_SALT) & _MASK


def _hash_coords(k: torch.Tensor, j: torch.Tensor, seed: int) -> torch.Tensor:
    """uint32 hash (as int64) of broadcast-compatible coordinates k, columns j."""
    h = _mul32(k, _K_SALT) ^ _mul32(j, _J_SALT) ^ seed_term(seed)
    return _mix32(h)


def srp_scale(d_prime: int) -> float:
    """1/sqrt(d_prime) rounded to f32, as the reference computes it."""
    return float(np.float32(1.0 / np.sqrt(float(d_prime))))


def srp_sign_entries(k: torch.Tensor, j: torch.Tensor, seed: int, d_total: int, d_prime: int):
    """f32 entries of S at int64 index tensors (k, j); rows k >= d_total are 0."""
    h = _hash_coords(k, j, seed)
    scale = torch.tensor(srp_scale(d_prime), dtype=torch.float32, device=h.device)
    sign = torch.where((h & 1) == 1, scale, -scale)
    return torch.where(k < d_total, sign, torch.zeros((), dtype=torch.float32, device=h.device))


def srp_sign_block(seed: int, k0: int, bd: int, d_prime: int, d_total: int, *, device="cuda"):
    """One (bd, d_prime) f32 block of S: rows k0 .. k0+bd, zero at k >= d_total."""
    dev = resolve_device(device)
    k = torch.arange(k0, k0 + bd, dtype=torch.int64, device=dev)[:, None]
    j = torch.arange(d_prime, dtype=torch.int64, device=dev)[None, :]
    return srp_sign_entries(k, j, seed, d_total, d_prime)


def countsketch_params(d: int, d_prime: int, seed: int, *, device="cuda"):
    """(bucket, sign) of the seeded counting sketch.

    ``bucket`` is (d,) int64 in [0, d_prime) (the reference's int32 values,
    in torch's index type); ``sign`` is (d,) f32 ±1.
    """
    dev = resolve_device(device)
    h = _hash_coords(torch.arange(d, dtype=torch.int64, device=dev), torch.zeros((), dtype=torch.int64, device=dev), seed)
    bucket = (h >> 1) % int(d_prime)
    sign = torch.where((h & 1) == 1, 1.0, -1.0).to(torch.float32)
    return bucket, sign


def sketch_srp_plain(X: torch.Tensor, d_prime: int, seed: int, block_d: int = 512) -> torch.Tensor:
    """Blockwise y = X @ S on X's device, in the reference's block order.

    Each (block_d, d_prime) block of S is regenerated and applied in turn,
    so memory stays O(n·d_prime + block_d·d_prime) however large d is.
    """
    X = X.to(torch.float32)
    n, d = X.shape
    out = torch.zeros((n, int(d_prime)), dtype=torch.float32, device=X.device)
    for k0 in range(0, d, block_d):
        bd = min(block_d, d - k0)
        S = srp_sign_block(seed, k0, bd, int(d_prime), d, device=X.device)
        out += X[:, k0 : k0 + bd] @ S
    return out


def countsketch_index(bucket: torch.Tensor, d_prime: int) -> torch.Tensor:
    """(d_prime, L) coordinates of each bucket in increasing order, padded with d.

    L is the largest bucket's size; the pad d points at a zero column that
    :func:`sketch_countsketch_plain` appends to X.
    """
    d = bucket.shape[0]
    order = torch.argsort(bucket, stable=True)
    counts = torch.bincount(bucket, minlength=int(d_prime))
    starts = torch.cumsum(counts, 0) - counts
    sorted_bucket = bucket[order]
    rank = torch.arange(d, device=bucket.device) - starts[sorted_bucket]
    idx = torch.full((int(d_prime), int(counts.max())), d, dtype=torch.int64, device=bucket.device)
    idx[sorted_bucket, rank] = order
    return idx


def sketch_countsketch_plain(X: torch.Tensor, d_prime: int, seed: int) -> torch.Tensor:
    """Seeded counting sketch on X's device, without float atomics.

    Each bucket's signed coordinates are gathered into one padded row and
    summed by one reduction, so the result is the same bits from call to
    call on the card (a scatter-add with atomics adds in no fixed order).
    """
    X = X.to(torch.float32)
    n, d = X.shape
    bucket, sign = countsketch_params(d, int(d_prime), seed, device=X.device)
    idx = countsketch_index(bucket, int(d_prime))
    signed = torch.cat([X * sign, torch.zeros((n, 1), dtype=torch.float32, device=X.device)], dim=1)
    return signed[:, idx].sum(dim=-1)


def _host(X) -> np.ndarray:
    """X as a host f32 numpy array (a tensor is copied off its device)."""
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    return np.asarray(X, np.float32)


def sketch_srp_reference(X, d_prime: int, seed: int, *, block_d: int = 512) -> np.ndarray:
    """Blockwise y = X @ S on the host, in numpy: the reference's own.

    Each (block_d, d_prime) block of S is regenerated and applied in turn,
    so host memory stays O(n·d_prime + block_d·d_prime) however large d is.
    """
    X = _host(X)
    n, d = X.shape
    out = np.zeros((n, int(d_prime)), np.float32)
    for k0 in range(0, d, block_d):
        bd = min(block_d, d - k0)
        S = srp_sign_block(seed, k0, bd, int(d_prime), d, device="cpu").numpy()
        out += X[:, k0 : k0 + bd] @ S
    return out


def sketch_countsketch_reference(X, d_prime: int, seed: int) -> np.ndarray:
    """Seeded counting sketch on the host (numpy's unbuffered scatter-add)."""
    X = _host(X)
    bucket, sign = countsketch_params(X.shape[1], int(d_prime), seed, device="cpu")
    acc = np.zeros((int(d_prime), X.shape[0]), np.float32)
    np.add.at(acc, bucket.numpy(), (X * sign.numpy()[None, :]).T)
    return acc.T
