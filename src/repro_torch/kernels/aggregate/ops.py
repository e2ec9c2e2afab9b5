"""Weighted sum of stacked flat rows through the CUDA aggregate kernel.

Port of ``src/repro/kernels/aggregate/ops.py``. :func:`aggregate_flat` is
the kernel's wrapper: for CUDA tensors it launches ``csrc/aggregate.cu``
on the grid of :func:`launch_plan`, for CPU tensors it runs the plain
version in ``ref.py``. It launches on the card that holds the tensors,
whichever device is current. :func:`aggregate_trees` is the weighted sum
of parameter trees (nested dicts, lists and tuples of tensors) through one
such call. :func:`work` is a call's operations and
bytes; a meta input returns an empty meta output, and every route adds
the call's work to the dry-run's running count (``_build.count_kernel``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Sequence

import torch

# the tree walk of the checkpoint bundles: jax.tree_util's leaf order
from repro_torch.checkpoint.io import _leaves, _rebuild
from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ref import aggregate_ref

#: SMs of an H100 SXM. A constant, not the card's count, so the plan is the
#: same on every card (the bits are in any case: each column's sum has one
#: order).
SMS = 132
#: The kernels' ``__launch_bounds__``: a block's threads at most.
MAX_THREADS = 256
#: Columns a thread, as in the kernel (one 4·VEC-byte load a row where rows
#: are aligned).
VEC = 2

#: Kernel launches since the count was last reset.
launches = {"aggregate": 0}


@functools.cache
def _lib():
    """The aggregate library, with its C signatures bound once."""
    lib = _build.load("aggregate")
    lib.aggregate_rows.restype = ctypes.c_int
    lib.aggregate_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.aggregate_empty_launch.restype = ctypes.c_int
    lib.aggregate_empty_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


@functools.cache
def launch_plan(k: int, p: int) -> tuple[int, int]:
    """(blocks, threads) for a (k, p) call: ⌈p / VEC⌉ column groups, one a
    thread, ⌈groups / SMS⌉ threads a block (at least one warp, at most
    MAX_THREADS), so the grid is one block on each SM. The kernel takes the
    rows in passes whatever k is, so k does not change the grid."""
    groups = -(-p // VEC)
    threads = min(MAX_THREADS, max(32, -(-groups // SMS)))
    return -(-groups // threads), threads


def work(k: int, p: int) -> tuple[int, int]:
    """(operations, bytes) of a (k, p) call: a multiply-add an element;
    the rows and weights read once, the (p,) sum written once."""
    return 2 * k * p, 4 * (k * p + k + p)


def aggregate_flat(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(k, p) f32 stacked flat rows × (k,) f32 weights -> (p,) Σ_k w_k U_k."""
    shape = updates.shape
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"updates must be (k, p) with k, p >= 1, got {tuple(shape)}")
    if weights.shape != shape[:1]:
        raise ValueError(f"weights shape {tuple(weights.shape)} != ({shape[0]},)")
    if updates.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"need float32, got {updates.dtype} and {weights.dtype}")
    if not updates.is_cuda and (updates.device.type not in ("cpu", "meta")
                                or weights.device.type != updates.device.type):
        raise ValueError(f"unsupported devices {updates.device} and {weights.device}")
    _build.count_kernel("aggregate", *work(*shape), updates)
    if updates.device.type == "meta":
        return updates.new_empty(shape[1])
    if updates.device.type == "cpu":
        with _build.uncounted():
            return aggregate_ref(updates, weights)
    dev = updates.get_device()
    if weights.get_device() != dev:
        raise ValueError(f"updates on {updates.device}, weights on {weights.device}")
    if not (updates.is_contiguous() and weights.is_contiguous()):
        raise ValueError("updates and weights must be contiguous")
    k, p = shape
    blocks, threads = launch_plan(k, p)
    out = updates.new_empty(p)
    lib = _lib()
    # the C entry point launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = lib.aggregate_rows(updates.data_ptr(), weights.data_ptr(), out.data_ptr(), k, p,
                                 blocks, threads, torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(lib, err, "aggregate kernel")
    launches["aggregate"] += 1
    _build.tally("aggregate")
    return out


def aggregate_trees(trees: Sequence, weights) -> Any:
    """Σ_k weights[k] · trees[k] for trees of one structure, in one launch.

    Each tree's leaves are flattened once into one f32 row of a (k, p)
    block, the rows are summed by :func:`aggregate_flat` (one kernel launch
    for CUDA tensors, the plain version for CPU ones), and the (p,) sum is
    cut back into each leaf's shape and dtype. ``weights`` (k,) may be
    numpy or a tensor; it is taken in f32.
    """
    if len(trees) != len(weights):
        raise ValueError(f"{len(trees)} trees vs {len(weights)} weights")
    like = [leaf for _, leaf in _leaves(trees[0])]
    dev = like[0].device
    p = sum(leaf.numel() for leaf in like)
    rows = torch.empty((len(trees), p), dtype=torch.float32, device=dev)
    for row, tree in zip(rows, trees):
        torch.cat([leaf.reshape(-1) for _, leaf in _leaves(tree)], out=row)
    w = torch.as_tensor(weights, device=dev).to(torch.float32)
    flat = aggregate_flat(rows, w)
    out, off = [], 0
    for leaf in like:
        out.append(flat[off: off + leaf.numel()].reshape(leaf.shape).to(leaf.dtype))
        off += leaf.numel()
    return _rebuild(trees[0], iter(out))
