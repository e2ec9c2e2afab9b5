"""Batched FL round engine on one device.

Port of ``src/repro/fl/engine.py``. The round runs every sampled client at
once:

  1. every client's train set is padded to a common length and staged once
     on the device as (n, n_pad, …) tensors; per round only the slot ids and
     the (m_slots, N, B) batch indices travel;
  2. the reference's ``vmap`` over clients is an explicit client axis: the
     parameters are stacked as (m_slots, in, out) and the local steps run
     through ``torch.baddbmm`` (:func:`repro_torch.fl.client.local_steps`);
  3. the eq. 3/4 aggregation (``stale_weight`` included) goes through the
     aggregate kernel, and the flat updates ``θ_i^{t+1} − θ^t`` (Algorithm 2
     line 1's input) stay on the device for the gradient store.

The client axis is always ``m_slots`` long; padded slots train on client 0
with weight 0, as in the reference. Batch indices are drawn from the
server's host rng per distinct client in distinct order, exactly as the
reference draws them, so both packages see the same batches.

Mesh sharding (``mesh=``, a :class:`repro_torch.launch.mesh.Mesh`): one
process drives every card. The ``m_slots`` client axis is split over the
mesh's data groups in ceil blocks (10 slots over 4 groups: 3, 3, 3, 1) and
each group runs the local steps of its slots on its first card, from a
replica of θ^t there. The staged dataset is split the same way by client
block when the data-parallel degree divides the client count (replicated
otherwise); a group gathers its slots' clients from the cards that own
them. The eq. 3/4 aggregation is the one cross-group step
(:func:`~repro_torch.fl.aggregation.aggregate_sharded`), the new global
model comes back on every card, and the flat updates stay on the cards
that computed them (a :class:`~repro_torch.launch.mesh.ShardedRows`). A
one-group mesh is the single-device round, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import Registry
from repro_torch.device import resolve_device
from repro_torch.fl.aggregation import (
    aggregate_rows,
    aggregate_sharded,
    flatten_params,
    replicate,
    stack_rows,
    unflatten_params,
)
from repro_torch.fl.client import LossFn, local_steps
from repro_torch.launch.mesh import (
    ShardedRows,
    blocks,
    check_lead,
    data_groups,
    data_parallel_degree,
    group_devices,
    lead_device,
    on_shard,
    resolve_fl_mesh,
)
from repro_torch.optim.base import Optimizer

#: dtypes the engine stages: f32 features for the dense matmul, int64 labels
#: and batch indices for torch indexing
FEATURE_DTYPE = torch.float32
INDEX_DTYPE = torch.int64


def staged_bytes(
    dataset, m_slots: int = 0, n_steps: int = 0, batch_size: int = 0, mesh=None
) -> int:
    """*Per-device* bytes the engine pins for ``dataset``: every client
    padded to the largest client, plus the per-round (m_slots, n_steps,
    batch_size) batch-index block.

    With ``mesh``, each term shrinks by the data-parallel degree when its
    leading axis divides it — how the engine shards (it stages replicated
    on uneven client counts)."""
    n_pad = max(c.n_train for c in dataset.clients)
    feat = int(np.prod(dataset.clients[0].x_train.shape[1:]))
    feat_b = FEATURE_DTYPE.itemsize
    idx_b = INDEX_DTYPE.itemsize
    data = dataset.n_clients * n_pad * (feat * feat_b + idx_b)
    idx = m_slots * n_steps * batch_size * idx_b
    if mesh is not None:
        n_dp = data_parallel_degree(mesh)
        if dataset.n_clients % n_dp == 0:
            data //= n_dp
        if m_slots % n_dp == 0:
            idx //= n_dp
    return data + idx


def stage(x: np.ndarray, y: np.ndarray, mesh) -> list:
    """The (n, n_pad, …) features and (n, n_pad) labels on ``mesh``: for
    each data group ``(lo, hi, x, y)``, its client block (or every client,
    replicated, when the degree does not divide n) on each of the group's
    devices — ``(lo, hi, [x on each device], [y on each device])``."""
    n, n_dp = x.shape[0], data_parallel_degree(mesh)
    spans = blocks(n, n_dp) if n % n_dp == 0 else [(0, n)] * n_dp
    out = []
    for (lo, hi), devs in zip(spans, data_groups(mesh)):
        xs = [torch.as_tensor(x[lo:hi], device=d) for d in devs]
        ys = [torch.as_tensor(y[lo:hi], device=d) for d in devs]
        out.append((lo, hi, xs, ys))
    return out


def _gather_plan(staged: list, group: int, ids: np.ndarray, dev) -> list:
    """Where the clients ``ids`` of data group ``group`` come from: for each
    staged block that holds some of them (the group's own first), its
    features, labels, the clients' rows in it (an index on its device) and
    their slots among ``ids`` (an index on ``dev``; None when it holds
    them all). Every index is copied to its device here, before the round
    queues any work: a copy from pageable host memory waits for the
    device's queue to drain."""
    own = staged[group]
    todo = np.ones(len(ids), dtype=bool)
    plan = []
    for lo, hi, xs, ys in [own] + [s for i, s in enumerate(staged) if i != group]:
        hit = todo & (ids >= lo) & (ids < hi)
        if not hit.any():
            continue
        todo &= ~hit
        local = torch.as_tensor(ids[hit] - lo, device=xs[0].device)
        slots = None if hit.all() else torch.as_tensor(np.flatnonzero(hit), device=dev)
        plan.append((xs[0], ys[0], local, slots))
    return plan


def _gather_clients(plan: list, n: int, dev):
    """The ``n`` clients of a :func:`_gather_plan`, features and labels on ``dev``."""
    x0, y0, local, slots = plan[0]
    if slots is None:
        return x0[local].to(dev), y0[local].to(dev)
    x = x0.new_empty((n,) + tuple(x0.shape[1:]), device=dev)
    y = y0.new_empty((n,) + tuple(y0.shape[1:]), device=dev)
    for xs, ys, local, slots in plan:
        x[slots] = xs[local].to(dev)
        y[slots] = ys[local].to(dev)
    return x, y


def batched_round_step(
    global_params: dict,
    x_all: torch.Tensor,  # (n, n_pad, …) stacked client features
    y_all: torch.Tensor,  # (n, n_pad) stacked client labels
    slot_ids: torch.Tensor,  # (m_slots,) client id per slot (0 for padding)
    batch_idx: torch.Tensor,  # (m_slots, N, B) per-slot batch indices
    weights,  # (m_slots,) realized ω, 0 for padded slots
    stale_weight: float,  # eq. 3 mass on θ^t
    *,
    loss_fn: LossFn,
    opt: Optimizer,
    fedprox_mu: float = 0.0,
    mesh=None,
):
    """One full FL round on the device.

    Returns (new_global_params, (m_slots, d) flat updates, (m_slots,) mean
    local losses). Padded slots train on client 0's data with weight 0 —
    their outputs are discarded by the caller.
    """
    if mesh is not None:
        return _sharded_round_step(
            global_params, x_all, y_all, slot_ids, batch_idx, weights, stale_weight,
            loss_fn=loss_fn, opt=opt, fedprox_mu=fedprox_mu, mesh=mesh,
        )
    m = int(slot_ids.shape[0])
    stacked = {k: v.unsqueeze(0).expand(m, *v.shape).contiguous() for k, v in global_params.items()}
    client_params, losses = local_steps(
        stacked, x_all[slot_ids], y_all[slot_ids], batch_idx, loss_fn, opt, fedprox_mu
    )
    rows = stack_rows(global_params, client_params)  # (m + 1, d), θ^t last
    new_flat = aggregate_rows(rows, weights, stale_weight)
    return unflatten_params(new_flat, global_params), rows[:m] - rows[m], losses


def _sharded_round_step(global_params, x_all, y_all, slot_ids, batch_idx, weights,
                        stale_weight, *, loss_fn, opt, fedprox_mu, mesh):
    """:func:`batched_round_step` over ``mesh``'s data groups. ``x_all`` /
    ``y_all`` are either tensors (every group gathers from them) or
    :func:`stage`'s placement; ``global_params`` are on the lead device,
    and the round starts by copying them to every group's card."""
    lead = lead_device(mesh)
    devs = group_devices(mesh)
    theta_lead = flatten_params(global_params)
    check_lead(mesh, theta_lead.device, "the round's global model")
    if not isinstance(x_all, list):
        n = int(x_all.shape[0])
        x_all = [(0, n, [x_all], [y_all])] * len(devs)
    ids = np.asarray(slot_ids.cpu() if isinstance(slot_ids, torch.Tensor) else slot_ids, np.int64)
    idx = np.asarray(batch_idx.cpu() if isinstance(batch_idx, torch.Tensor) else batch_idx)
    w = np.asarray(weights, np.float32)
    spans = blocks(len(ids), len(devs))
    # every host-to-device copy of the round first (see _gather_plan)
    work = []
    for g, ((a, b), dev) in enumerate(zip(spans, devs)):
        if a < b:
            wg = w[a:b] if g else np.append(w[a:b], np.float32(stale_weight))
            work.append((g, a, b, dev, _gather_plan(x_all, g, ids[a:b], dev),
                         torch.as_tensor(idx[a:b], device=dev), torch.as_tensor(wg, device=dev)))
    params_on = {}
    for dev, t in zip(devs, replicate(theta_lead, mesh)):
        if dev not in params_on:
            params_on[dev] = global_params if t is theta_lead else unflatten_params(t, global_params)
    parts, losses, updates, groups = [], [], [], []
    for g, a, b, dev, plan, idx_g, w_g in work:
        with on_shard(g, dev):
            p = params_on[dev]
            stacked = {k: v.unsqueeze(0).expand(b - a, *v.shape).contiguous() for k, v in p.items()}
            x, y = _gather_clients(plan, b - a, dev)
            client_params, loss = local_steps(stacked, x, y, idx_g, loss_fn, opt, fedprox_mu)
            rows = stack_rows(p, client_params)  # (k + 1, d), θ^t last
        parts.append((g, rows if g == 0 else rows[: b - a], w_g))
        updates.append(rows[: b - a] - rows[b - a])
        groups.append(g)
        losses.append(loss.to(lead))
    new_flat = aggregate_sharded(parts, lead)
    updates = ShardedRows(updates, theta_lead.numel(), groups)
    return unflatten_params(new_flat, global_params), updates, torch.cat(losses)


class BatchedRoundEngine:
    """Stages a :class:`~repro_torch.data.federated.FederatedDataset` on
    ``device`` once and runs rounds through :func:`batched_round_step`.

    ``m_slots`` fixes the padded client axis (normally the sampler's m).
    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` or any
    ``FLConfig.mesh_spec`` form) stages the dataset over the mesh's data
    groups (by client block when the degree divides the client count,
    replicated otherwise) and runs every round with the slot axis split;
    its lead device must be ``device``.
    """

    def __init__(
        self,
        dataset,
        m_slots: int,
        n_steps: int,
        batch_size: int,
        *,
        device="cuda",
        mesh=None,
    ):
        if m_slots <= 0:
            raise ValueError("m_slots must be positive")
        self.device = resolve_device(device)
        mesh = resolve_fl_mesh(mesh, device=self.device.type)
        if mesh is not None:
            check_lead(mesh, self.device, "the batched engine")
        self.mesh = mesh
        self.m_slots = int(m_slots)
        self.n_steps = int(n_steps)
        self.batch_size = int(batch_size)
        self._n_train = np.array([c.n_train for c in dataset.clients])
        n_pad = int(self._n_train.max())
        feat = dataset.clients[0].x_train.shape[1:]
        x_all = np.zeros((dataset.n_clients, n_pad) + feat, dtype=np.float32)
        y_all = np.zeros((dataset.n_clients, n_pad), dtype=np.int64)
        for i, c in enumerate(dataset.clients):
            x_all[i, : c.n_train] = c.x_train
            y_all[i, : c.n_train] = c.y_train
        # device-resident for the whole run; per-round traffic is indices only
        if mesh is None:
            self._x_all = torch.as_tensor(x_all, device=self.device)
            self._y_all = torch.as_tensor(y_all, device=self.device)
        else:
            self._x_all = stage(x_all, y_all, mesh)
            self._y_all = None

    def per_device_staged_bytes(self) -> int:
        """Measured bytes the busiest device pins for the staged dataset,
        counted by mesh position (four CPU shards are four devices).

        The per-round batch-index block is a transient, not counted here —
        :func:`staged_bytes` is the planning-time estimate that includes it.
        """
        return max(self.staged_bytes_by_position())

    def staged_bytes_by_position(self) -> list:
        """Staged bytes of each mesh position, in the mesh's device order
        (one entry without a mesh)."""
        if self.mesh is None:
            return [self._x_all.nbytes + self._y_all.nbytes]
        by_group = [[x.nbytes + y.nbytes for x, y in zip(xs, ys)]
                    for _, _, xs, ys in self._x_all]
        # data_groups lists each group's devices in mesh order along the
        # non-batch axes; with the batch axes leading, that is flat order
        return [b for group in by_group for b in group]

    def run_round(
        self,
        params: dict,
        distinct: np.ndarray,
        weights: np.ndarray,
        stale_weight: float,
        rng: np.random.Generator,
        loss_fn: LossFn,
        opt: Optimizer,
        fedprox_mu: float = 0.0,
    ):
        """Returns (new_params, (c, d) flat updates, (c,) losses) for the
        ``c = len(distinct)`` realized clients."""
        c = len(distinct)
        if c == 0 or c > self.m_slots:
            raise ValueError(f"got {c} distinct clients for {self.m_slots} slots")
        slot_ids = np.zeros(self.m_slots, dtype=np.int64)
        slot_ids[:c] = distinct
        idx = np.zeros((self.m_slots, self.n_steps, self.batch_size), dtype=np.int64)
        for i, cid in enumerate(distinct):
            # same rng stream as the compat loop's draw_batch_indices
            idx[i] = rng.integers(
                0, int(self._n_train[int(cid)]), size=(self.n_steps, self.batch_size)
            )
        w = np.zeros(self.m_slots, dtype=np.float32)
        w[:c] = weights
        sharded = self.mesh is not None
        new_params, updates, losses = batched_round_step(
            params,
            self._x_all,
            self._y_all,
            slot_ids if sharded else torch.as_tensor(slot_ids, device=self.device),
            idx if sharded else torch.as_tensor(idx, device=self.device),
            w,
            float(stale_weight),
            loss_fn=loss_fn,
            opt=opt,
            fedprox_mu=fedprox_mu,
            mesh=self.mesh,
        )
        # updates stay on the devices: the gradient store scatters them
        return new_params, updates[:c], losses[:c].cpu().numpy()


# --------------------------------------------------------------------------
# engine registry: FLConfig.engine resolves through this
# --------------------------------------------------------------------------
def _batched_engine(dataset, m: int, config, device, mesh=None):
    return BatchedRoundEngine(
        dataset, m, config.n_local_steps, config.batch_size, device=device, mesh=mesh
    )


def _compat_engine(dataset, m: int, config, device, mesh=None):
    """The per-client reference loop lives in the server; no engine object."""
    del dataset, m, config, device, mesh
    return None


#: name -> factory(dataset, m, config, device, mesh) returning an object
#: with ``run_round(params, distinct, weights, stale_weight, rng, loss_fn,
#: opt, fedprox_mu)`` — or None to select the server's compat per-client
#: loop (which ignores the mesh).
ENGINES = Registry("engine", {"batched": _batched_engine, "compat": _compat_engine})

register_engine = ENGINES.register
