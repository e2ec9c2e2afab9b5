"""Device meshes for the FL round's client axis, driven from one process.

Port of ``src/repro/launch/mesh.py``. A :class:`Mesh` is a grid of
``torch.device``s with the reference's axis names ("data", "model"). One
Python process drives every device of it, as one jitted program drives the
reference's mesh: an array whose leading axis is "per client" (the round's
slots, the staged client data, the gradient store's rows) is split over the
mesh's batch axes in GSPMD's ceil blocks (:func:`blocks`), each data
group's work runs on the group's first device, and "model" replicates: a
group's block is placed on every device of the group. The one cross-group
reduction (eq. 3/4) copies each group's partial to the lead device and adds
them in group order (:func:`repro_torch.fl.aggregation.aggregate_sharded`).

``make_host_mesh(..., device="cpu")`` builds CPU shards, all
``torch.device("cpu")``: the counterpart of the reference's
``--xla_force_host_platform_device_count``, which is how the tests get four
shards. Byte counts are kept by mesh position, so four CPU shards count as
four devices.

:func:`make_production_mesh` is the reference's 256 / 512-position mesh on
meta positions, each a device of its own (``Mesh.keys``), as the
reference's are 512 placeholder host devices: the dry-run
(``launch/dryrun.py``) counts the port's steps on it. The copies between
positions report their bytes to the dry-run's counter
(``_build.count_moved``): ``ShardedRows.gather`` as an all-gather.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices`` (an object ndarray of ``torch.device``) with one axis
    name per dimension, as ``jax.sharding.Mesh(devices, axis_names)``.
    ``keys`` names, position by position, the device each position stands
    for where ``devices`` cannot tell them apart (meta positions):
    positions with one key share their device's storage and work
    (:meth:`device_key`)."""

    devices: np.ndarray
    axis_names: tuple
    keys: tuple = ()

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device_key(self, position: int) -> str:
        """The device of ``position`` as a key."""
        return self.keys[position] if self.keys else str(self.devices.flat[position])

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh: 16 × 16 over ("data", "model"), or
    2 × 16 × 16 over ("pod", "data", "model"), of meta positions
    (:func:`make_meta_mesh`). No host has 256 cards; the dry-run runs the
    port's steps on it."""
    if multi_pod:
        return make_meta_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_meta_mesh((16, 16))


def make_meta_mesh(shape, axes=AXES, cards=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` of meta positions (tensors with no
    data), each a device of its own, or with ``cards`` the positions of a
    mesh over that many cards in turn (position p on card p % cards), as
    many devices as cards."""
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("meta")] * n
    keys = tuple(f"meta:{p if cards is None else p % cards}" for p in range(n))
    return Mesh(devs.reshape(tuple(shape)), axes, keys)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda") -> Mesh:
    """A (data, model) mesh: cards ``0 … data·model − 1`` on ``"cuda"``
    (raising when fewer are visible, as ``jax.make_mesh`` does), or
    data·model CPU shards on ``"cpu"``."""
    dev = resolve_device(device)
    n = int(data) * int(model)
    if n < 1:
        raise ValueError(f"mesh shape ({data}, {model}) has no devices")
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count < n:
            raise ValueError(
                f"Number of devices {count} must be >= the product of mesh_shape "
                f"({int(data)}, {int(model)})"
            )
        flat = [torch.device("cuda", i) for i in range(n)]
    else:
        flat = [torch.device("cpu")] * n
    devs = np.empty(n, dtype=object)
    devs[:] = flat
    return Mesh(devs.reshape(int(data), int(model)), AXES)


def resolve_fl_mesh(spec, *, device="cuda") -> Optional[Mesh]:
    """Map ``FLConfig.mesh_spec`` to a mesh (or ``None``).

    * ``None`` — no mesh: the engine's single-device behaviour.
    * ``"auto"`` — every visible card on the "data" axis (one shard on the
      CPU).
    * ``"DxM"`` (e.g. ``"4x1"``) or ``(D, M)`` — a host mesh with D-way data
      parallelism and M-way model parallelism.
    * a :class:`Mesh` — used as is.
    """
    if spec is None:
        return None
    if isinstance(spec, Mesh):
        return spec
    if isinstance(spec, str):
        if spec == "auto":
            dev = resolve_device(device)
            count = torch.cuda.device_count() if dev.type == "cuda" else 1
            return make_host_mesh(count, 1, device=device)
        parts = spec.lower().split("x")
        if len(parts) in (1, 2) and all(p.isdigit() and p for p in parts):
            return make_host_mesh(
                int(parts[0]), int(parts[1]) if len(parts) == 2 else 1, device=device
            )
    elif isinstance(spec, (tuple, list)) and len(spec) in (1, 2):
        data, *rest = spec
        return make_host_mesh(int(data), int(rest[0]) if rest else 1, device=device)
    raise ValueError(
        f"bad mesh_spec {spec!r}; expected None, 'auto', 'DxM', (D, M), or a Mesh"
    )


def batch_axes(mesh: Mesh) -> tuple:
    """Axes that shard the batch / client dimension."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_parallel_degree(mesh: Mesh) -> int:
    """Total device count across the batch axes."""
    size = 1
    for a in batch_axes(mesh):
        size *= mesh.shape[a]
    return size


def leading_batch_spec(mesh: Mesh, ndim: int) -> tuple:
    """The reference's ``PartitionSpec`` as a tuple: the leading axis on the
    mesh's batch axes, trailing dims replicated."""
    dp = batch_axes(mesh)
    lead = dp if len(dp) > 1 else dp[0]
    return (lead, *([None] * (ndim - 1)))


def mesh_chips(mesh: Mesh) -> int:
    return mesh.devices.size


def data_group_positions(mesh: Mesh) -> list:
    """The mesh positions (indices into ``mesh.devices.flat``) of each data
    group, groups in batch-axis order."""
    batch = [mesh.axis_names.index(a) for a in batch_axes(mesh)]
    rest = [i for i in range(len(mesh.axis_names)) if i not in batch]
    pos = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    return [row.tolist() for row in pos.transpose(batch + rest).reshape(data_parallel_degree(mesh), -1)]


def data_groups(mesh: Mesh) -> list:
    """The devices of each data group, groups in batch-axis order."""
    return [[mesh.devices.flat[p] for p in row] for row in data_group_positions(mesh)]


def group_devices(mesh: Mesh) -> list:
    """Each data group's first device: where the group's work runs."""
    return [g[0] for g in data_groups(mesh)]


def lead_device(mesh: Mesh) -> torch.device:
    """The mesh's first device: it holds θ, the snapshot and the sum."""
    return mesh.devices.flat[0]


def blocks(n: int, parts: int) -> list:
    """GSPMD's ceil blocks of a length-``n`` axis over ``parts`` groups:
    ``[lo, hi)`` each; 10 over 4 are 3, 3, 3, 1 (a block may be empty)."""
    size = -(-int(n) // int(parts))
    return [(min(n, g * size), min(n, (g + 1) * size)) for g in range(parts)]


def same_device(a, b) -> bool:
    """Whether two devices are one, a CUDA device without an index being
    the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if a.index is None or b.index is None else None
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def check_lead(mesh: Mesh, device, who: str) -> None:
    """Raise unless ``device`` is the mesh's lead device."""
    if not same_device(lead_device(mesh), device):
        raise ValueError(
            f"{who} runs on {torch.device(device)} but the mesh's lead device is "
            f"{lead_device(mesh)}; the lead device holds the global model, so the "
            "two must be one"
        )


class on_shard:
    """Run the enclosed work as mesh position ``shard`` on ``device``: the
    current CUDA device is ``device`` (for the library calls that read it)
    and the kernels' launches are tallied under ``shard``
    (:data:`repro_torch.kernels._build.shard_launches`)."""

    def __init__(self, shard: int, device):
        self.shard, self.device = int(shard), torch.device(device)

    def __enter__(self):
        self._prev = _build.set_shard(self.shard)
        self._cuda = torch.cuda.device(self.device) if self.device.type == "cuda" else None
        if self._cuda is not None:
            self._cuda.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cuda is not None:
            self._cuda.__exit__(*exc)
        _build.set_shard(self._prev)


def sync_mesh(mesh: Optional[Mesh]) -> None:
    """Wait for the work queued on every card of ``mesh``."""
    if mesh is None:
        return
    seen = set()
    for d in mesh.devices.flat:
        if d.type == "cuda" and d.index not in seen:
            seen.add(d.index)
            torch.cuda.synchronize(d)


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """The port's ``NamedSharding``: ``spec`` names, dim by dim, the mesh
    axes that split it (``None``: replicated) — the reference's
    ``PartitionSpec`` as a tuple."""

    mesh: Mesh
    spec: tuple


class ShardedRows:
    """(c, d) rows held as consecutive blocks, each on its own device: a
    round's per-client updates as the data groups computed them.

    ``groups`` names each block's data group (default: the block's index);
    empty blocks are dropped. Slicing with ``[a:b]`` and a boolean row mask
    (numpy or tensor) keep the rows where they are; :meth:`gather` copies
    them to one device.
    """

    def __init__(self, blocks: Sequence[torch.Tensor], width: int,
                 groups: Optional[Sequence[int]] = None):
        groups = range(len(blocks)) if groups is None else groups
        kept = [(g, b) for g, b in zip(groups, blocks) if b.shape[0]]
        self.groups = [g for g, _ in kept]
        self.blocks = [b for _, b in kept]
        self.width = int(width)
        self._lead = blocks[0].device if len(blocks) else torch.device("cpu")

    @property
    def shape(self) -> tuple:
        return (sum(b.shape[0] for b in self.blocks), self.width)

    @property
    def device(self) -> torch.device:
        return self._lead

    @property
    def dtype(self):
        return self.blocks[0].dtype if self.blocks else torch.float32

    def __len__(self) -> int:
        return self.shape[0]

    def _select(self, keep: np.ndarray) -> "ShardedRows":
        out, off = [], 0
        for b in self.blocks:
            k = keep[off:off + b.shape[0]]
            off += b.shape[0]
            out.append(b if k.all() else b[torch.as_tensor(k, device=b.device)])
        rows = ShardedRows(out, self.width, self.groups)
        rows._lead = self._lead
        return rows

    def __getitem__(self, key) -> "ShardedRows":
        n = len(self)
        if isinstance(key, slice):
            if key.step not in (None, 1):
                raise IndexError("ShardedRows takes contiguous slices only")
            keep = np.zeros(n, dtype=bool)
            keep[key] = True
            return self._select(keep)
        keep = key.cpu().numpy() if isinstance(key, torch.Tensor) else np.asarray(key)
        if keep.dtype != bool or keep.shape != (n,):
            raise IndexError(f"ShardedRows takes a slice or a ({n},) boolean mask")
        return self._select(keep)

    def gather(self, device) -> torch.Tensor:
        """All the rows, in order, on ``device`` (each block moved from its
        data group's position to the running one)."""
        if not self.blocks:
            return torch.empty((0, self.width), device=device)
        here = _build.current_shard() or 0
        for g, b in zip(self.groups, self.blocks):
            _build.count_moved("all-gather", g, here, b.numel() * b.element_size())
        return torch.cat([b.to(device) for b in self.blocks])
