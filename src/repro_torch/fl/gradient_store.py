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
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sketch.ops import Sketcher, resolve_sketcher


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
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_clients = int(n_clients)
        self.update_dim = int(update_dim)
        self.sketch = resolve_sketcher(sketch, self.update_dim, sketch_dim, seed=sketch_seed)
        #: resident row width — d' under a compressing sketch, d otherwise
        self.dim = self.update_dim if self.sketch is None else self.sketch.d_out
        self.staleness_decay = float(staleness_decay)
        self._G = torch.zeros((self.n_clients, self.dim), dtype=torch.float32, device=self.device)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the (n_clients, dim) f32 buffer."""
        return self.n_clients * self.dim * 4

    def _rows(self, client_ids, updates) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids, rows) to write: shape-checked, deduplicated last-write-wins,
        out-of-range ids dropped, then sketched."""
        if tuple(updates.shape)[1:] != (self.update_dim,):
            raise ValueError(
                f"updates shape {tuple(updates.shape)} != (len(ids), {self.update_dim})"
            )
        if len(client_ids) != updates.shape[0]:
            raise ValueError(f"{len(client_ids)} ids for {updates.shape[0]} update rows")
        ids = np.asarray(client_ids, np.int64)
        if (ids < 0).any():
            raise ValueError(f"negative client id in {ids.tolist()}")
        take = _dedupe_last(ids)
        vals = torch.as_tensor(updates).to(device=self.device, dtype=torch.float32)
        if not isinstance(take, slice):
            ids, vals = ids[take], vals[torch.as_tensor(take, device=self.device)]
        keep = ids < self.n_clients
        if not keep.all():
            ids, vals = ids[keep], vals[torch.as_tensor(keep, device=self.device)]
        if self.sketch is not None:
            vals = self.sketch(vals.contiguous()) if ids.size else vals.new_zeros((0, self.dim))
        return torch.as_tensor(ids, device=self.device), vals

    def update(self, client_ids, updates) -> None:
        """Scatter ``updates`` (c, update_dim) into rows ``client_ids`` (c,).

        ``updates`` may be a device tensor (the engine's round output) or a
        numpy array; the sketch stage (if any) runs on it on the store's
        device before the scatter. Ids at or beyond ``n_clients`` are
        dropped; duplicate ids resolve last-write-wins.
        """
        ids, vals = self._rows(client_ids, updates)
        if self.staleness_decay < 1.0:
            self._G.mul_(self.staleness_decay)
        self._G.index_copy_(0, ids, vals)

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
        ids, vals = self._rows(client_ids, updates)
        if ids.numel() == 0:
            return
        self._G.index_copy_(0, ids, vals * scale)

    def snapshot(self) -> torch.Tensor:
        """A copy of the current G on the device."""
        return self._G.clone()

    def gather_rows(self, client_ids) -> torch.Tensor:
        """Only the requested rows."""
        return self._G[torch.as_tensor(np.asarray(client_ids, np.int64), device=self.device)]

    def load(self, G) -> None:
        """Replace the buffer with a (n_clients, dim) state (tensor or numpy)."""
        if tuple(G.shape) != (self.n_clients, self.dim):
            raise ValueError(
                f"checkpointed G shape {tuple(G.shape)} != ({self.n_clients}, {self.dim})"
            )
        if isinstance(G, torch.Tensor):
            if G.dtype != torch.float32:
                raise ValueError(f"G must be float32, got {G.dtype}")
        else:
            G = torch.from_numpy(np.asarray(G, np.float32))
        self._G = G.to(self.device, copy=True)

    def asnumpy(self) -> np.ndarray:
        """Host f32 copy, for inspection and host-side reference builds."""
        return self._G.cpu().numpy()
