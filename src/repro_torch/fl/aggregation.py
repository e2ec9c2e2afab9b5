"""Server-side model aggregation through the aggregate kernel.

Port of ``src/repro/fl/aggregation.py``. Unbiased schemes (eq. 4):
``θ^{t+1} = Σ_k (1/m) θ_{l_k}`` — a weighted sum of the distinct updated
models with the realized weights ``ω_i``; FedAvg-style biased sampling
(eq. 3) adds ``stale_weight · θ^t``. Every form here stacks the flat client
models, appends θ^t as one more row carrying ``stale_weight``, and sums the
rows with :func:`repro_torch.kernels.aggregate.ops.aggregate_flat`:
:func:`weighted_tree_sum` (and :func:`aggregate_round` through it) by
:func:`~repro_torch.kernels.aggregate.ops.aggregate_trees`, the engine's
stacked form by :func:`stack_rows`.

Flat vectors follow the reference's ``jax.tree_util`` order for a dict:
leaves sorted by key.

Over a device mesh (:func:`aggregate_sharded`) the kernel runs once on each
data group's card over the group's rows; θ^t's row and ``stale_weight``
ride with the lead group. The partials are copied to the lead card one at
a time and added in group order, and the sum is copied back to every
group's card (:func:`replicate`). With one group this is the unsharded
call, bit for bit. Each partial's copy to the lead reports its bytes to
the dry-run's counter as an all-reduce (``_build.count_moved``).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.aggregate.ops import aggregate_flat, aggregate_trees
from repro_torch.launch.mesh import data_group_positions, on_shard


def flatten_params(tree: dict) -> torch.Tensor:
    """Flatten a parameter dict into one vector (sorted-key order)."""
    return torch.cat([tree[k].reshape(-1) for k in sorted(tree)])


def unflatten_params(flat: torch.Tensor, like: dict) -> dict:
    """Inverse of :func:`flatten_params` for the shapes and dtypes of ``like``."""
    out, off = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[off : off + n].reshape(like[k].shape).to(like[k].dtype)
        off += n
    return out


def stack_rows(global_params: dict, stacked_params: dict) -> torch.Tensor:
    """(c + 1, p) f32 kernel input: the c flat client models of
    ``stacked_params`` (leaves (c, ...)), then θ^t as the last row, each
    written straight into one buffer."""
    keys = sorted(global_params)
    c = stacked_params[keys[0]].shape[0]
    p = sum(global_params[k].numel() for k in keys)
    dev = global_params[keys[0]].device
    rows = torch.empty((c + 1, p), dtype=torch.float32, device=dev)
    torch.cat([stacked_params[k].reshape(c, -1) for k in keys], dim=1, out=rows[:c])
    torch.cat([global_params[k].reshape(-1) for k in keys], out=rows[c])
    return rows


def aggregate_rows(rows: torch.Tensor, weights, stale_weight: float) -> torch.Tensor:
    """Σ_c w_c · rows[c] + stale_weight · rows[-1] for :func:`stack_rows`'
    output, in one kernel launch."""
    w = np.append(np.asarray(weights, dtype=np.float32), np.float32(stale_weight))
    return aggregate_flat(rows, torch.as_tensor(w, device=rows.device))


def aggregate_stacked(global_params: dict, stacked_params: dict, weights, stale_weight):
    """Eq. 3/4 over a stacked client axis (leaves (c, ...)); padded slots
    carry weight 0 and contribute nothing."""
    flat = aggregate_rows(stack_rows(global_params, stacked_params), weights, stale_weight)
    return unflatten_params(flat, global_params)


def weighted_tree_sum(trees: Sequence, weights) -> dict:
    """Σ_k w_k · tree_k over parameter trees of one structure, in one
    aggregate launch (leaves in the reference's ``jax.tree_util`` order)."""
    return aggregate_trees(trees, np.asarray(weights, dtype=np.float32))


def aggregate_round(
    global_params: dict,
    client_params: Sequence[dict],
    client_weights: np.ndarray,
    stale_weight: float = 0.0,
):
    """Combine distinct client models (+ optional stale global mass): θ^t
    is the last tree, carrying ``stale_weight``."""
    if len(client_params) != len(client_weights):
        raise ValueError(f"{len(client_params)} models vs {len(client_weights)} weights")
    weights = np.append(np.asarray(client_weights, dtype=np.float32), np.float32(stale_weight))
    return weighted_tree_sum([*client_params, global_params], weights)


def aggregate_sharded(shards: Iterable, lead: torch.device) -> torch.Tensor:
    """Σ over the mesh's data groups of each group's Σ_c w_c · rows[c].

    ``shards`` yields ``(group, rows, weights)`` with ``rows`` (k, p) f32
    and ``weights`` (k,) on the group's card, the lead group first (its
    last row θ^t, its last weight ``stale_weight``); ``group`` is the mesh
    position the group's work runs as, the lead's 0. One kernel launch a
    group; each partial is copied to ``lead`` and added in group order
    before the next group's launch, so at most one foreign (p,) partial is
    resident on ``lead``.
    """
    total = None
    for group, rows, w in shards:
        with on_shard(group, rows.device):
            part = aggregate_flat(rows, w)
        _build.count_moved("all-reduce", group, 0, part.numel() * part.element_size())
        part = part.to(lead)
        total = part if total is None else total.add_(part)
        del part
    return total


def replicate(flat: torch.Tensor, mesh) -> list:
    """``flat``, held at ``mesh``'s lead position, on each data group's
    first position's device, in group order: one copy a distinct device
    (``Mesh.device_key``; the lead's keeps ``flat``), made as that
    position; each group's copy reports its bytes to the dry-run's counter
    as a collective-permute."""
    by_key, out = {mesh.device_key(0): flat}, []
    for row in data_group_positions(mesh):
        pos = row[0]
        _build.count_moved("collective-permute", 0, pos, flat.numel() * flat.element_size())
        key = mesh.device_key(pos)
        if key not in by_key:
            with on_shard(pos, mesh.devices.flat[pos]):
                by_key[key] = torch.empty_like(flat, device=mesh.devices.flat[pos]).copy_(flat)
        out.append(by_key[key])
    return out
