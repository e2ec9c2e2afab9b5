"""Weighted sum of stacked flat rows through the CUDA aggregate kernel.

Port of ``src/repro/kernels/aggregate/ops.py``. :func:`aggregate_flat` is
the kernel's wrapper: for CUDA tensors it launches ``csrc/aggregate.cu``,
for CPU tensors it runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import aggregate_ref

#: Kernel launches since the count was last reset.
launches = {"aggregate": 0}


@functools.cache
def _lib():
    """The aggregate library, with its C signature bound once."""
    lib = _build.load("aggregate")
    lib.aggregate_rows.restype = ctypes.c_int
    lib.aggregate_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


def aggregate_flat(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(k, p) f32 stacked flat rows × (k,) f32 weights -> (p,) Σ_k w_k U_k."""
    if updates.dim() != 2 or updates.shape[0] < 1 or updates.shape[1] < 1:
        raise ValueError(f"updates must be (k, p) with k, p >= 1, got {tuple(updates.shape)}")
    if tuple(weights.shape) != (updates.shape[0],):
        raise ValueError(f"weights shape {tuple(weights.shape)} != ({updates.shape[0]},)")
    if updates.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"need float32, got {updates.dtype} and {weights.dtype}")
    if updates.device != weights.device:
        raise ValueError(f"updates on {updates.device}, weights on {weights.device}")
    if updates.device.type == "cpu":
        return aggregate_ref(updates, weights)
    if updates.device.type != "cuda":
        raise ValueError(f"unsupported device {updates.device}")
    if not (updates.is_contiguous() and weights.is_contiguous()):
        raise ValueError("updates and weights must be contiguous")
    k, p = updates.shape
    out = torch.empty(p, dtype=torch.float32, device=updates.device)
    lib = _lib()
    err = lib.aggregate_rows(
        updates.data_ptr(),
        weights.data_ptr(),
        out.data_ptr(),
        k,
        p,
        torch.cuda.current_stream(updates.device).cuda_stream,
    )
    _build.check(lib, err, "aggregate kernel")
    launches["aggregate"] += 1
    return out
