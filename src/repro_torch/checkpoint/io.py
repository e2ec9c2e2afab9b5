# Adapted from src/repro/checkpoint/io.py: the tree walk is the port's own
# (no jax), keyed exactly as jax's tree_flatten_with_path keys it, and
# tensor leaves restore onto their reference tensor's device.
"""Flat-dict ``.npz`` checkpointing with step metadata.

Trees (nested dicts, lists and tuples of numpy arrays and tensors) are
flattened to ``a/b/c`` path keys: dict keys in sorted order, sequence items
by index, ``None`` holding no leaf — the keys and order jax gives the same
tree, so a bundle written by either package restores in the other. Restore
rebuilds against a reference tree (structure from the caller, arrays from
disk). The bundle is one ``.npz`` with the JSON metadata in a ``__meta__``
uint8 entry, written to a temporary file and renamed into place.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Iterator

import numpy as np
import torch


def _leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(path key, leaf) pairs in jax's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype in (torch.bfloat16, torch.float16):
            leaf = leaf.float()  # lossless up-cast, as the reference's bf16 leaves
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub?":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def _rebuild(tree: Any, values: Iterator) -> Any:
    """``tree``'s structure with its leaves replaced, in :func:`_leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], values) for k in sorted(tree)}
        return {k: out[k] for k in tree}  # the caller's key order
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


def save_checkpoint(path: str, tree: Any, *, step: int = 0, extra: dict | None = None) -> None:
    flat = _flatten(tree)
    meta = {"step": int(step), "extra": extra or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def peek_meta(path: str) -> tuple[int, dict]:
    """Read just ``(step, extra)`` from a bundle, no array restore.

    Lets callers validate a bundle's provenance (which subsystems wrote it)
    and raise their own errors *before* the structural restore turns a
    missing section into a generic missing-leaf failure.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
    return int(meta["step"]), dict(meta.get("extra") or {})


def restore_checkpoint(
    path: str, reference: Any, *, dynamic_prefixes: tuple[str, ...] = ()
) -> tuple[Any, int, dict]:
    """Restore arrays into the structure of ``reference``.

    Returns ``(tree, step, extra)`` — ``extra`` is the JSON side-channel
    ``save_checkpoint`` was given (``{}`` when none was saved). The
    reference is authoritative for structure AND residence: a leaf that is
    a numpy array in ``reference`` comes back as numpy of that exact dtype
    (f64 sampler state stays f64); a tensor leaf comes back on that
    tensor's device with its dtype; any other leaf comes back as numpy of
    its own dtype. Missing leaves, shape mismatches and leaves present in
    the ``.npz`` but absent from the reference are all errors — a
    silently-ignored leaf is state that a resumed run would quietly lose.

    ``dynamic_prefixes`` exempts subtrees from the shape guard: a leaf whose
    path key starts with one of the prefixes takes its shape from disk
    (dtype and residence still from the reference). This is for genuinely
    variable-shaped state such as a straggler harvest buffer.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    leaves, seen = [], set()
    for key, ref_leaf in _leaves(reference):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        seen.add(key)
        arr = flat[key]
        dynamic = any(key.startswith(p) for p in dynamic_prefixes)
        ref_shape = tuple(np.shape(ref_leaf))
        if not dynamic and arr.shape != ref_shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected {ref_shape}")
        if isinstance(ref_leaf, torch.Tensor):
            leaves.append(
                torch.from_numpy(np.ascontiguousarray(arr)).to(ref_leaf.device, ref_leaf.dtype)
            )
        else:
            leaves.append(np.asarray(arr, dtype=np.asarray(ref_leaf).dtype))
    unknown = set(flat) - seen
    if unknown:
        raise KeyError(
            f"checkpoint holds leaf(s) {sorted(unknown)} that the reference "
            "tree does not — refusing to silently drop state on restore"
        )
    tree = _rebuild(reference, iter(leaves))
    return tree, int(meta["step"]), dict(meta.get("extra") or {})
