"""Placement rules: parameter, optimizer-state, batch and cache placements.

Port of ``src/repro/launch/sharding.py``. Scheme: FSDP on the batch axes ×
tensor parallel on "model".

* column-parallel 2D weights (d_in, d_out): ``(fsdp, "model")``
* row-parallel    2D weights (names below): ``("model", fsdp)``
* embedding (V, D): ``("model", fsdp)``; lm_head (D, V): ``(fsdp, "model")``.
* MoE expert stacks (E, d, f): the *ffn* dim on "model"; expert parallel (E
  on "model") with ``expert_parallel=True``.
* norms / small vectors / scalars: replicated.
* the reference's ``stack`` leaves carry a leading ``None`` for the repeat
  axis; the port holds each layer's tensor on its own, so each takes the
  rest of the spec.

A placement is a :class:`~repro_torch.launch.mesh.Placement`, whose ``spec``
is the reference's ``PartitionSpec`` as a tuple. The rules are keyed on the
port's :class:`~repro_torch.models.model.LM` through
:func:`~repro_torch.models.model.reference_leaves`, so a parameter's spec is
the one its reference leaf gets; a dim that does not divide its mesh axes
is left unsplit, as in the reference.

:func:`place` is ``jax.device_put(tree, shardings)``: it returns a
:class:`Placed` tensor for each leaf, one block per mesh position (a
``jax.Array``'s ``addressable_shards``), each block of
``NamedSharding.shard_shape``. Positions on one device
(``Mesh.device_key``) that hold the same block share one tensor; bytes are
still counted by position (:func:`bytes_by_position`, and
:func:`placement_bytes` from the placements alone).

The copies between positions report their bytes to the dry-run's counter
(``_build.count_moved``), by (from, to) position whatever the devices:
:meth:`Placed.gather` as an all-gather, :meth:`Placed.add_` as a
reduce-scatter, :func:`place_tensor` under the kind its caller names.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import _build
from repro_torch.launch.mesh import (
    Mesh,
    Placement,
    batch_axes,
    data_parallel_degree,
    on_shard,
    same_device,
)
from repro_torch.models import model as mdl

# row-parallel: input dim carries the "model" shard
_ROW_PARALLEL = ("w_down", "w_out")
_REPLICATED_1D = ("scale", "bias", "lam", "out_norm", "q_norm", "k_norm")
# Attention-family projections are FSDP-only (d_in sharded over batch axes,
# d_out replicated): the reference's attention is sequence-parallel over
# the model axis (models/sharding_hints.py).
_FSDP_ONLY = ("wq", "wk", "wv", "wo", "w_dkv", "w_kr")


def param_spec(path: str, ndim: int, fsdp, *, expert_parallel: bool = False) -> tuple:
    """The spec of one parameter leaf (its own dims; a stacked leaf's repeat
    axis is the caller's), as the reference's ``param_spec``."""
    name = path.split("/")[-1]
    fs = tuple(fsdp) if len(fsdp) > 1 else fsdp[0] if fsdp else None

    if name == "embed":
        return ("model", fs)
    if name == "lm_head":
        return (fs, "model")
    if name in ("e_gate", "e_up"):  # (E, d, f)
        return ("model", fs, None) if expert_parallel else (None, fs, "model")
    if name == "e_down":  # (E, f, d)
        return ("model", None, fs) if expert_parallel else (None, "model", fs)
    if name in ("w_uk", "w_uv"):  # MLA (R, H, hd)
        return (None, None, None)
    if name in _FSDP_ONLY:
        return (fs, None) if ndim == 2 else (None,) * ndim
    if name.startswith("r_"):  # sLSTM per-head recurrent (H, hd, hd)
        return (None, None, None)
    if name == "conv_w":  # (cw, w)
        return (None, "model")
    if ndim == 2:
        if name in _ROW_PARALLEL:
            return ("model", fs)
        return (fs, "model")
    if ndim == 1:
        if name in _REPLICATED_1D or name.startswith("b_"):
            return (None,)
        return ("model",)  # attention biases bq/bk/bv etc.
    return (None,) * ndim


def axes_size(mesh: Mesh, entry) -> int:
    """The number of blocks a spec entry splits its dim into."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in names)


def param_shardings(mesh: Mesh, params: mdl.LM, *, expert_parallel: bool = False) -> dict:
    """The placement of each of ``params``' tensors, by parameter name
    (also the placements of its gradients and updates)."""
    fsdp = batch_axes(mesh)
    named = dict(params.named_parameters())
    out = {}
    for path, names in mdl.reference_leaves(params):
        for n in names:
            shape = tuple(named[n].shape)
            spec = param_spec("/".join(path), len(shape), fsdp, expert_parallel=expert_parallel)
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            # never split a dim that does not divide its mesh axes
            out[n] = Placement(mesh, tuple(e if d % axes_size(mesh, e) == 0 else None
                                           for e, d in zip(spec, shape)))
    return out


def opt_state_shardings(mesh: Mesh, opt_state: Any, params_shardings: dict) -> Any:
    """Adam's moments ``mu`` / ``nu`` mirror the parameters' placements;
    every other leaf is replicated."""

    def one(path, leaf):
        if len(path) == 2 and path[0] in ("mu", "nu") and path[1] in params_shardings:
            return params_shardings[path[1]]
        return _replicated(mesh, leaf)

    return tree_map(one, opt_state)


def _dp(mesh: Mesh):
    fsdp = batch_axes(mesh)
    return tuple(fsdp) if len(fsdp) > 1 else fsdp[0]


def batch_shardings(mesh: Mesh, batch: Any) -> Any:
    """Token batches: the leading (global batch) dim on the batch axes when
    the data-parallel degree divides it, else replicated."""
    dp, n = _dp(mesh), data_parallel_degree(mesh)

    def one(_, leaf):
        shape = _shape(leaf)
        if shape and shape[0] % n == 0:
            return Placement(mesh, (dp,) + (None,) * (len(shape) - 1))
        return _replicated(mesh, leaf)

    return tree_map(one, batch)


def cache_shardings(mesh: Mesh, caches: Any, cfg) -> Any:
    """Decode caches: batch on the batch axes when divisible; the length
    dim of k / v on "model" (else their kv-head dim), the length dim of
    MLA's latent; a recurrent state's width on "model"."""
    del cfg
    dp, n_batch = _dp(mesh), data_parallel_degree(mesh)
    n_model = mesh.shape["model"]

    def one(path, leaf):
        eff = _shape(leaf)
        dims: list = [None] * len(eff)
        name = str(path[-1]) if path else ""
        if not eff:  # the position
            return Placement(mesh, ())
        if eff[0] % n_batch == 0 and eff[0] >= n_batch:
            dims[0] = dp
        if name in ("k", "v", "ck", "cv") and len(eff) == 4:
            # length-split, as the reference's sequence-parallel decode
            if eff[1] % n_model == 0:
                dims[1] = "model"
            elif eff[2] % n_model == 0:  # else the kv heads
                dims[2] = "model"
        elif name in ("c", "k_rope") and len(eff) == 3:
            if eff[1] % n_model == 0:
                dims[1] = "model"
        elif len(eff) >= 2 and eff[-1] % n_model == 0:
            dims[-1] = "model"  # recurrent width
        return Placement(mesh, tuple(dims))

    return tree_map(one, caches)


def replicated(mesh: Mesh, tree: Any) -> Any:
    return tree_map(lambda _, leaf: _replicated(mesh, leaf), tree)


def _replicated(mesh: Mesh, leaf) -> Placement:
    return Placement(mesh, (None,) * len(_shape(leaf)))


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _children(tree):
    """(key, child) pairs of a dict, list, tuple or LM (its parameters by
    name); None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (an LM as the dict of its parameters by name), keeping the structure."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = {k: tree_map(fn, v, path + (k,)) for k, v in kids}
    if isinstance(tree, (list, tuple)):
        return type(tree)(out[i] for i in range(len(tree)))
    return out


# --------------------------------------------------------------------------
# placed tensors
# --------------------------------------------------------------------------
def block_index(placement: Placement, shape, position: int) -> tuple:
    """The slices of a ``shape`` tensor that mesh position ``position`` (an
    index into ``mesh.devices.flat``) holds under ``placement``: a spec
    entry's axes number the blocks major to minor, as
    ``NamedSharding.devices_indices_map``. Raises where an entry's axes do
    not divide their dim (``jax.device_put`` refuses it too)."""
    mesh = placement.mesh
    coord = dict(zip(mesh.axis_names, np.unravel_index(position, mesh.devices.shape)))
    spec = tuple(placement.spec) + (None,) * (len(shape) - len(placement.spec))
    out = []
    for entry, dim in zip(spec, shape):
        if entry is None:
            out.append(slice(0, dim))
            continue
        k = 0
        for a in (entry,) if isinstance(entry, str) else entry:
            k = k * mesh.shape[a] + int(coord[a])
        n = axes_size(mesh, entry)
        if dim % n:
            raise ValueError(f"spec {placement.spec} splits a dim of {dim} into {n} blocks; "
                             f"{dim} is not divisible by {n}")
        out.append(slice(k * (dim // n), (k + 1) * (dim // n)))
    return tuple(out)


def shard_shape(placement: Placement, shape) -> tuple:
    """Each block's shape (``NamedSharding.shard_shape``)."""
    return tuple(s.stop - s.start for s in block_index(placement, tuple(shape), 0))


def _numel(index: tuple) -> int:
    return math.prod(s.stop - s.start for s in index)


def _slot(index: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in index)


class Placed:
    """A tensor under a :class:`Placement`: ``blocks[i]`` is the block of
    mesh position ``i`` (``mesh.devices.flat`` order), on that position's
    device. Blocks of positions that share a device and hold the same
    slices are one tensor."""

    def __init__(self, placement: Placement, shape, dtype, blocks: list):
        self.placement = placement
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks = blocks
        self._index = [block_index(placement, self.shape, p) for p in range(len(blocks))]

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    def index(self, position: int) -> tuple:
        """The slices of the whole tensor that ``position`` holds."""
        return self._index[position]

    def stored(self) -> list:
        """One position for each distinct stored block (the first that holds it)."""
        seen, out = set(), []
        for pos, b in enumerate(self.blocks):
            if id(b) not in seen:
                seen.add(id(b))
                out.append(pos)
        return out

    def distinct(self) -> list:
        """One position for each distinct block of the whole tensor,
        whatever its device: every element once."""
        seen, out = set(), []
        for pos in range(len(self.blocks)):
            key = _slot(self.index(pos))
            if key not in seen:
                seen.add(key)
                out.append(pos)
        return out

    def gather(self, device, out: torch.Tensor = None) -> torch.Tensor:
        """The whole tensor on ``device`` (into ``out`` when given) at the
        running mesh position (``on_shard``; the first when none runs),
        each block taken from that position where it holds it, else from
        ``device`` where a position there holds it."""
        device = torch.device(device)
        if out is None:
            out = torch.empty(self.shape, dtype=self.dtype, device=device)
        devs = self.mesh.devices.flat
        here = _build.current_shard() or 0
        done = set()
        for pos in sorted(range(len(self.blocks)),
                          key=lambda p: (p != here, not same_device(devs[p], device))):
            idx = self.index(pos)
            if _slot(idx) not in done:
                done.add(_slot(idx))
                dst = out[idx]
                dst.copy_(self.blocks[pos])
                _build.count_moved("all-gather", pos, here, dst.numel() * dst.element_size())
        return out

    def add_(self, whole: torch.Tensor) -> None:
        """Add the matching slices of ``whole`` into each stored block; each
        position receives its slice from ``whole``'s position."""
        for pos in self.stored():
            b = self.blocks[pos]
            b.add_(whole[self.index(pos)].to(b.device))
        if _build.counting():
            for pos in range(len(self.blocks)):
                _build.count_moved("reduce-scatter", whole, pos,
                                   _numel(self.index(pos)) * whole.element_size())

    def bytes_by_position(self) -> list:
        return [b.numel() * b.element_size() for b in self.blocks]

    def __repr__(self):
        return f"Placed({self.shape}, {self.dtype}, spec={self.placement.spec})"


def place_tensor(t: torch.Tensor, placement: Placement, *,
                 kind: str = "collective-permute") -> Placed:
    """``t`` under ``placement``: each block a new tensor on its position's
    device (a copy, whatever ``t``'s device), made as that position; each
    position receives its block from ``t``'s position, counted as ``kind``."""
    shape, made, blocks = tuple(t.shape), {}, []
    mesh = placement.mesh
    with torch.no_grad():
        for pos, dev in enumerate(mesh.devices.flat):
            idx = block_index(placement, shape, pos)
            key = (mesh.device_key(pos), _slot(idx))
            if key not in made:
                part = t[idx]
                with on_shard(pos, dev):
                    made[key] = torch.empty(part.shape, dtype=t.dtype, device=dev).copy_(part)
            blocks.append(made[key])
            _build.count_moved(kind, t, pos, _numel(idx) * t.element_size())
    return Placed(placement, shape, t.dtype, blocks)


def place(tree: Any, placements: Any) -> Any:
    """``tree``'s tensors under ``placements`` (the same structure, an LM
    standing for the dict of its parameters by name): ``jax.device_put``.
    A leaf that is not a tensor (a cache's position) is kept as it is."""
    kids = _children(tree)
    if kids is None:
        return place_tensor(tree, placements) if isinstance(tree, torch.Tensor) else tree
    out = {k: place(v, placements[k]) for k, v in kids}
    if isinstance(tree, (list, tuple)):
        return type(tree)(out[i] for i in range(len(tree)))
    return out


def placement_bytes(placements: Any, like: Any) -> list:
    """The bytes each mesh position would hold of ``like``'s tensors (meta
    stand-ins will do) under ``placements`` (the same structure): the
    blocks' sizes, no tensor made. Every position holds a block of the
    same shape."""
    sizes: list = []  # (positions, bytes a position) of each tensor

    def walk(pl, t):
        kids = _children(t)
        if kids is None:
            if isinstance(t, torch.Tensor):
                sizes.append((pl.mesh.devices.size,
                              math.prod(shard_shape(pl, t.shape)) * t.element_size()))
            return
        for k, v in kids:
            walk(pl[k], v)

    walk(placements, like)
    return [sum(n for _, n in sizes)] * sizes[0][0] if sizes else []


def bytes_by_position(tree: Any) -> list:
    """The bytes each mesh position holds of ``tree``'s placed tensors."""
    total = None
    for placed in leaves(tree):
        b = placed.bytes_by_position()
        total = b if total is None else [x + y for x, y in zip(total, b)]
    return total or []


def leaves(tree: Any) -> list:
    """The :class:`Placed` leaves of ``tree``, in order."""
    kids = _children(tree)
    if kids is None:
        return [tree] if isinstance(tree, Placed) else []
    return [p for _, v in kids for p in leaves(v)]
