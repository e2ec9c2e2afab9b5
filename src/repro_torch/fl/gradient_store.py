"""Device-resident representative-gradient store for Algorithm 2.

Port of ``src/repro/fl/gradient_store.py``. ``G`` is an (n_clients, dim)
f32 tensor on the device, and each round's ``θ_i^{t+1} − θ^t`` rows (the
engine's device output) are folded in with ``index_copy_``:

* staleness decay (the beyond-paper age-out of clients not sampled for many
  rounds) multiplies the whole buffer in place first;
* ids at or beyond ``n_clients`` are dropped by an explicit bounds check,
  which is how fixed-shape padded slot blocks mark unused rows (the
  reference's scatter ``mode="drop"``);
* duplicate ids are last-write-wins (:func:`_dedupe_last`);
* with ``sketch=`` a :data:`repro_torch.kernels.sketch.SKETCHERS` entry
  compresses the kept (c, d) rows to (c, d') before the scatter (the SRP
  kernel on the card), so the resident buffer is (n, d') and the plan
  rebuild behind it scales in d'. The SRP kernel's rows do not depend on
  which other rows share a call, so sketching after the deduplication
  stores the same bits as sketching every incoming row.
  ``sketch="identity"`` is bit for bit the unsketched store.

The store is updated in place, so :meth:`snapshot` returns a copy: an
async planner worker may read it while the next round scatters.

With ``mesh_spec`` (any ``FLConfig.mesh_spec`` form, resolved on
``device``, whose card must be the mesh's lead) the rows are split over the
mesh's data groups by client block when the data-parallel degree divides
``n_clients``, and replicated otherwise; a group's block sits on each of
its devices. :meth:`update` sketches the incoming rows where they live (a
:class:`~repro_torch.launch.mesh.ShardedRows` block by block, each on its
own card, so the SRP kernel runs once a block there) and then sends each
(c, d′) row to the cards that own it. :meth:`snapshot` returns the whole
(n, dim) on the lead card (the reference's plan build all-gathers too),
:meth:`gather_rows` only the asked rows, and :meth:`load` re-places a
checkpoint onto the blocks, whichever way it was written.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sketch.ops import Sketcher, resolve_sketcher
from repro_torch.launch.mesh import (
    ShardedRows,
    blocks,
    check_lead,
    data_groups,
    data_parallel_degree,
    on_shard,
    resolve_fl_mesh,
)


def _dedupe_last(ids: np.ndarray) -> np.ndarray:
    """Indices of the *last* occurrence of each id, in stable id-order.

    Pins last-write-wins for duplicate client ids. Returns ``slice(None)``
    (no-op indexer) when ids are already unique.
    """
    uniq, last_of_reversed = np.unique(ids[::-1], return_index=True)
    if uniq.size == ids.size:
        return slice(None)
    return ids.size - 1 - last_of_reversed


class GradientStore:
    """(n_clients, dim) f32 buffer of latest representative gradients.

    ``dim`` is the resident width: ``update_dim`` without a sketch (or with
    the identity sketch), the sketcher's ``d_out`` otherwise. ``update``
    implements the seed sampler's semantics: decay the whole buffer by
    ``staleness_decay`` (1.0 = paper behaviour, a no-op), sketch the
    incoming rows, then overwrite the observed clients' rows.
    """

    def __init__(
        self,
        n_clients: int,
        update_dim: int,
        *,
        staleness_decay: float = 1.0,
        sketch: Union[str, Sketcher, None] = None,
        sketch_dim: Optional[int] = None,
        sketch_seed: int = 0,
        mesh_spec=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_clients = int(n_clients)
        self.update_dim = int(update_dim)
        self.sketch = resolve_sketcher(sketch, self.update_dim, sketch_dim, seed=sketch_seed)
        #: resident row width — d' under a compressing sketch, d otherwise
        self.dim = self.update_dim if self.sketch is None else self.sketch.d_out
        self.staleness_decay = float(staleness_decay)
        self.mesh = resolve_fl_mesh(mesh_spec, device=self.device.type)
        if self.mesh is None:
            # one block of every row, on the store's device
            self._parts = [(0, self.n_clients, [self.device])]
        else:
            check_lead(self.mesh, self.device, "the gradient store")
            n_dp = data_parallel_degree(self.mesh)
            split = self.n_clients % n_dp == 0
            spans = blocks(self.n_clients, n_dp) if split else [(0, self.n_clients)] * n_dp
            self._parts = [(lo, hi, devs) for (lo, hi), devs in zip(spans, data_groups(self.mesh))]
            if not split:  # replicated: one part of every row on every device
                self._parts = [(0, self.n_clients, [d for _, _, ds in self._parts for d in ds])]
        self._blocks = [
            [torch.zeros((hi - lo, self.dim), dtype=torch.float32, device=d) for d in devs]
            for lo, hi, devs in self._parts
        ]

    @property
    def _G(self) -> torch.Tensor:
        """The lead block (the whole buffer without a mesh)."""
        return self._blocks[0][0]

    @property
    def nbytes(self) -> int:
        """Resident bytes of the (n_clients, dim) f32 buffer."""
        return self.n_clients * self.dim * 4

    def bytes_by_position(self) -> list:
        """Resident bytes of each mesh position, in the mesh's device order
        (one entry without a mesh)."""
        return [b.nbytes for group in self._blocks for b in group]

    def _rows(self, client_ids, updates) -> list:
        """The rows to write as ``(ids, vals)`` pairs, one a block of
        ``updates`` (a tensor on another device than the store's is one
        block, moved to the store's device first): shape-checked,
        deduplicated last-write-wins, out-of-range ids dropped, then
        sketched on the block's device."""
        if tuple(updates.shape)[1:] != (self.update_dim,):
            raise ValueError(
                f"updates shape {tuple(updates.shape)} != (len(ids), {self.update_dim})"
            )
        if len(client_ids) != updates.shape[0]:
            raise ValueError(f"{len(client_ids)} ids for {updates.shape[0]} update rows")
        ids = np.asarray(client_ids, np.int64)
        if (ids < 0).any():
            raise ValueError(f"negative client id in {ids.tolist()}")
        if isinstance(updates, ShardedRows):
            parts = list(zip(updates.groups, updates.blocks))
        else:
            parts = [(None, torch.as_tensor(updates).to(device=self.device, dtype=torch.float32))]
        take = _dedupe_last(ids)
        if isinstance(take, slice):
            take = np.arange(ids.size)
        take = take[ids[take] < self.n_clients]  # kept row positions, in order
        out, off = [], 0
        for g, vals in parts:
            rows = take[(take >= off) & (take < off + vals.shape[0])]
            off += vals.shape[0]
            if rows.size == 0:
                continue
            local = rows - (off - vals.shape[0])
            if local.size != vals.shape[0] or (local != np.arange(local.size)).any():
                vals = vals[torch.as_tensor(local, device=vals.device)]
            if self.sketch is not None:
                with nullcontext() if g is None else on_shard(g, vals.device):
                    vals = self.sketch(vals.to(torch.float32).contiguous())
            out.append((ids[rows], vals))
        return out

    def _write(self, rows: list, scale: Optional[float] = None) -> None:
        """Overwrite each block's rows with ``rows``' values (times
        ``scale``), on each device that holds the block."""
        for (lo, hi, _), copies in zip(self._parts, self._blocks):
            for ids, vals in rows:
                mine = (ids >= lo) & (ids < hi)
                if not mine.any():
                    continue
                sel = vals if mine.all() else vals[torch.as_tensor(mine, device=vals.device)]
                if scale is not None:
                    sel = sel * scale
                for G in copies:
                    G.index_copy_(0, torch.as_tensor(ids[mine] - lo, device=G.device),
                                  sel.to(G.device))

    def update(self, client_ids, updates) -> None:
        """Scatter ``updates`` (c, update_dim) into rows ``client_ids`` (c,).

        ``updates`` may be a device tensor (the engine's round output), a
        :class:`~repro_torch.launch.mesh.ShardedRows` (a sharded round's) or
        a numpy array; the sketch stage (if any) runs where the rows live
        before the scatter. Ids at or beyond ``n_clients`` are dropped;
        duplicate ids resolve last-write-wins.
        """
        rows = self._rows(client_ids, updates)
        if self.staleness_decay < 1.0:
            for copies in self._blocks:
                for G in copies:
                    G.mul_(self.staleness_decay)
        self._write(rows)

    def scatter_scaled(self, client_ids, updates, *, scale: float = 1.0) -> None:
        """Overwrite rows ``client_ids`` with ``scale · updates`` — no decay.

        The harvest-replay path (``DeadlineScheduler``): a straggler's update
        delivered after the deadline lands in the *next* round's store,
        discounted by ``scale``, without re-applying the whole-buffer
        staleness decay that :meth:`update` already charged. Sketching,
        id-dropping and last-write-wins match :meth:`update`; the scale
        multiplies the sketched rows (the sketches are linear). The shape is
        checked before an empty update returns, as in the reference.
        """
        self._write(self._rows(client_ids, updates), scale=scale)

    def snapshot(self) -> torch.Tensor:
        """A copy of the current G on the store's (the lead) device."""
        if len(self._blocks) == 1:
            return self._G.clone()
        return torch.cat([copies[0].to(self.device) for copies in self._blocks])

    def gather_rows(self, client_ids) -> torch.Tensor:
        """Only the requested rows, on the store's (the lead) device."""
        ids = np.asarray(client_ids, np.int64)
        if len(self._blocks) == 1:
            return self._G[torch.as_tensor(ids, device=self.device)]
        out = torch.empty((ids.size, self.dim), dtype=torch.float32, device=self.device)
        for (lo, hi, _), copies in zip(self._parts, self._blocks):
            mine = (ids >= lo) & (ids < hi)
            if mine.any():
                G = copies[0]
                got = G[torch.as_tensor(ids[mine] - lo, device=G.device)]
                out[torch.as_tensor(np.flatnonzero(mine), device=self.device)] = got.to(self.device)
        return out

    def load(self, G) -> None:
        """Replace the buffer with a (n_clients, dim) state (tensor on any
        device, or numpy), re-placed onto the store's blocks."""
        if tuple(G.shape) != (self.n_clients, self.dim):
            raise ValueError(
                f"checkpointed G shape {tuple(G.shape)} != ({self.n_clients}, {self.dim})"
            )
        if isinstance(G, torch.Tensor):
            if G.dtype != torch.float32:
                raise ValueError(f"G must be float32, got {G.dtype}")
        else:
            G = torch.from_numpy(np.asarray(G, np.float32))
        self._blocks = [
            [G[lo:hi].to(copy.device, copy=True) for copy in copies]
            for (lo, hi, _), copies in zip(self._parts, self._blocks)
        ]

    def asnumpy(self) -> np.ndarray:
        """Host f32 copy, for inspection and host-side reference builds (a
        copy on the CPU too: it does not follow later scatters)."""
        G = self._G if len(self._blocks) == 1 else self.snapshot()
        return G.numpy().copy() if G.device.type == "cpu" else G.cpu().numpy()
