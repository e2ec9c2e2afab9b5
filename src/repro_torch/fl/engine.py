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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.registry import Registry
from repro_torch.device import resolve_device
from repro_torch.fl.aggregation import aggregate_rows, stack_rows, unflatten_params
from repro_torch.fl.client import LossFn, local_steps
from repro_torch.optim.base import Optimizer

#: dtypes the engine stages: f32 features for the dense matmul, int64 labels
#: and batch indices for torch indexing
FEATURE_DTYPE = torch.float32
INDEX_DTYPE = torch.int64


def staged_bytes(dataset, m_slots: int = 0, n_steps: int = 0, batch_size: int = 0) -> int:
    """Device bytes the engine pins for ``dataset``: every client padded to
    the largest client, plus the per-round (m_slots, n_steps, batch_size)
    batch-index block."""
    n_pad = max(c.n_train for c in dataset.clients)
    feat = int(np.prod(dataset.clients[0].x_train.shape[1:]))
    feat_b = FEATURE_DTYPE.itemsize
    idx_b = INDEX_DTYPE.itemsize
    data = dataset.n_clients * n_pad * (feat * feat_b + idx_b)
    return data + m_slots * n_steps * batch_size * idx_b


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
        raise NotImplementedError("mesh sharding is not ported; pass mesh=None")
    m = int(slot_ids.shape[0])
    stacked = {k: v.unsqueeze(0).expand(m, *v.shape).contiguous() for k, v in global_params.items()}
    client_params, losses = local_steps(
        stacked, x_all[slot_ids], y_all[slot_ids], batch_idx, loss_fn, opt, fedprox_mu
    )
    rows = stack_rows(global_params, client_params)  # (m + 1, d), θ^t last
    new_flat = aggregate_rows(rows, weights, stale_weight)
    return unflatten_params(new_flat, global_params), rows[:m] - rows[m], losses


class BatchedRoundEngine:
    """Stages a :class:`~repro_torch.data.federated.FederatedDataset` on
    ``device`` once and runs rounds through :func:`batched_round_step`.

    ``m_slots`` fixes the padded client axis (normally the sampler's m).
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
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported; pass mesh=None")
        if m_slots <= 0:
            raise ValueError("m_slots must be positive")
        self.device = resolve_device(device)
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
        self._x_all = torch.as_tensor(x_all, device=self.device)
        self._y_all = torch.as_tensor(y_all, device=self.device)

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
        new_params, updates, losses = batched_round_step(
            params,
            self._x_all,
            self._y_all,
            torch.as_tensor(slot_ids, device=self.device),
            torch.as_tensor(idx, device=self.device),
            w,
            float(stale_weight),
            loss_fn=loss_fn,
            opt=opt,
            fedprox_mu=fedprox_mu,
        )
        # updates stay on the device: the gradient store scatters them
        return new_params, updates[:c], losses[:c].cpu().numpy()


# --------------------------------------------------------------------------
# engine registry: FLConfig.engine resolves through this
# --------------------------------------------------------------------------
def _batched_engine(dataset, m: int, config, device):
    return BatchedRoundEngine(
        dataset, m, config.n_local_steps, config.batch_size, device=device
    )


def _compat_engine(dataset, m: int, config, device):
    """The per-client reference loop lives in the server; no engine object."""
    del dataset, m, config, device
    return None


#: name -> factory(dataset, m, config, device) returning an object with
#: ``run_round(params, distinct, weights, stale_weight, rng, loss_fn, opt,
#: fedprox_mu)`` — or None to select the server's compat per-client loop.
ENGINES = Registry("engine", {"batched": _batched_engine, "compat": _compat_engine})
