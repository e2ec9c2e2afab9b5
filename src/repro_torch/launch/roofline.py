"""Three-term roofline of the port's steps, from the dry-run's counts.

Port of ``src/repro/launch/roofline.py``:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes accessed / HBM bandwidth
    collective = bytes moved between mesh positions / link bandwidth

each for one mesh position (the dry-run takes the largest position's). The
reference reads XLA's per-device cost analysis of a compiled SPMD program
and parses the collectives out of its HLO; eager PyTorch has neither, so
:class:`CostCounter` counts the port's own step as it runs, on meta
tensors, on the CPU or on the card alike, by mesh position:

* FLOPs by torch's flop registry (``torch.utils.flop_counter``: matrix
  products, convolutions and attention; elementwise work counts none);
* bytes accessed: each aten op that runs a kernel reads each tensor
  argument once (an argument it only writes, as ``copy_``'s, is not read)
  and writes each output once; views, allocations and copies between
  devices or between mesh positions (a copy reading a tensor that another
  position holds) count none: the copies count as moved bytes;
* each hand kernel's calls and work, from its wrapper's ``work`` formula
  (``_build.count_kernel``); the torch ops of a kernel's plain version are
  left out (``_build.uncounted``), so every route counts the same;
* bytes moved between positions by collective kind
  (``_build.count_moved``; :data:`COLLECTIVES` are the reference's five):
  ``Placed.gather`` (a data group's whole-model gather, its batch rows)
  and ``ShardedRows.gather`` as all-gathers; ``Placed.add_`` and the
  gradients' ``place_tensor`` (each block's gradient sent where the block
  lives) as reduce-scatters; the train step's loss, metrics and global
  norm to the lead and the clip scale back, the federated round's losses
  and ``aggregate_sharded``'s partial sums to the lead as all-reduces; the
  federated round's θ^t, client batches and weights from the lead as
  collective-permutes. A copy within a position moves nothing; a
  position's moved bytes are the larger of what it sends and what it
  receives (the links are full duplex);
* the peak of the live bytes each position's work allocated.

An op runs at the running mesh position (``on_shard``), else at the
position that holds its first tensor argument, else at position 0.
Positions that share a device (``Mesh.device_key``) share the work on
their shared blocks, counted at the first of them.

Hardware constants: NVIDIA H100 SXM5 80 GB at its 700 W power limit, from
NVIDIA's data sheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s
HBM3, 450 GB/s NVLink each way. ``LINK_BW`` assumes that every position of
the mesh reaches every other at NVLink's rate, as the reference assumes
its pod's ICI links; 256 cards span several hosts of 8, and the data sheet
gives no rate for the network between hosts.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.models import model as mdl

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores / card
HBM_BW = 3.35e12  # B/s per card
LINK_BW = 450e9  # B/s per card, NVLink each way

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

_aten = torch.ops.aten
#: ops that run no kernel: allocations and aliases the schema does not mark as views
_NO_KERNEL = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
              _aten.new_empty_strided, _aten._unsafe_view, _aten.lift_fresh, _aten.set_,
              _aten.resize_, _aten._local_scalar_dense}
#: ops whose first argument is written, not read
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.normal_, _aten.uniform_,
               _aten.random_, _aten.exponential_}


_IMPLICIT = torch._C.DispatchKey.CompositeImplicitAutograd
_COMPOSITE: set = set()  # ops with a CompositeImplicitAutograd kernel
_KERNEL: set = set()  # ops without one


def _composite(func) -> bool:
    if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), "CompositeImplicitAutograd"):
        _COMPOSITE.add(func)
        return True
    _KERNEL.add(func)
    return False


def _tensors(xs) -> list:
    """The tensors among ``xs`` and inside its lists and tuples."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += [y for y in x if isinstance(y, torch.Tensor)]
    return out


class CostCounter(TorchDispatchMode):
    """Counts the work of the enclosed torch ops, hand kernels and copies
    between mesh positions, by position (see the module docstring).
    ``positions`` is the mesh's size (1 without a mesh); ``placed`` holds
    the trees of :class:`~repro_torch.launch.sharding.Placed` tensors the
    step starts from, so that each block's work runs at its position."""

    def __init__(self, positions: int = 1, placed=()):
        super().__init__()
        n = self.positions = int(positions)
        self.flops = [0] * n
        self.bytes = [0] * n
        self.kernels: dict = {}
        self.colls = {k: {"count": [0] * n, "bytes": [0] * n} for k in COLLECTIVES}
        self.sent, self.received = [0] * n, [0] * n
        self.pairs: collections.Counter = collections.Counter()  # (from, to) -> bytes moved
        self.live, self.peak, self.end = [0] * n, [0] * n, [0] * n
        self.by_op: collections.Counter = collections.Counter()  # bytes accessed by op
        self.paused = 0
        self._depth = 0
        self._where: dict = {}  # id(storage) -> position
        self._refs: dict = {}  # id(storage) -> weakref dropping the entry when it is freed
        from repro_torch.launch.sharding import leaves

        for tree in placed:
            for leaf in leaves(tree):
                for pos, block in enumerate(leaf.blocks):
                    self._track(block.untyped_storage(), pos, 0)

    def __enter__(self):
        if not self._depth:
            self._prev = _build.set_counter(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                self.end = list(self.live)
                _build.set_counter(self._prev)
                self._refs.clear()  # no callback after the count

    # -- positions and live bytes ------------------------------------------
    def _track(self, st, pos: int, nbytes: int) -> None:
        key = id(st)
        if key in self._where:
            return
        self._where[key] = pos

        def gone(_, key=key, pos=pos, n=nbytes):
            self._where.pop(key, None)
            self._refs.pop(key, None)
            self.live[pos] -= n

        self._refs[key] = weakref.ref(st, gone)
        if nbytes:
            self.live[pos] += nbytes
            self.peak[pos] = max(self.peak[pos], self.live[pos])

    def _between(self, packet, args, pos: int) -> bool:
        """Whether a copy reads a tensor held at another position than the
        one it writes: a copy between positions, which moves bytes
        (counted where it is made) rather than accessing them."""
        if packet is _aten.copy_ and len(args) > 1:
            src, dst = self._held_at(args[1]), self._held_at(args[0])
        elif packet is _aten._to_copy:
            src, dst = self._held_at(args[0]), pos
        else:
            return False
        return src is not None and dst is not None and src != dst

    def _held_at(self, t: torch.Tensor):
        return self._where.get(id(t.untyped_storage()))

    def _position(self, t: torch.Tensor) -> int:
        pos = _build.current_shard()
        if pos is None:
            pos = self._held_at(t)
        return 0 if pos is None else pos

    # -- the counts --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _COMPOSITE or (func not in _KERNEL and _composite(func)):
            # reached undecomposed (inference mode): count its parts, always
            # through the C++ composite kernel (``decompose`` prefers a
            # Python one once ``torch._decomp`` is imported)
            with self:
                return func._op_dk(_IMPLICIT, *args, **kwargs)
        out = func(*args, **kwargs)
        if self.paused:
            return out
        if func.overloadpacket is _aten.log_sigmoid_forward:
            # CPU and CUDA write the output contiguous, the meta kernel in its
            # input's strides; its buffer is CPU-only scratch
            if out[0].device.type == "meta":
                out = (torch.empty(out[0].shape, dtype=out[0].dtype, device=out[0].device), out[1])
            outs = [out[0]]
        else:
            outs = _tensors((out,))
        ins = _tensors(args) + _tensors(kwargs.values())
        pos = _build.current_shard()
        if pos is None:
            pos = next((p for p in map(self._held_at, ins) if p is not None), 0)
        where = self._where
        for t in ins:
            st = t.untyped_storage()
            if id(st) not in where:
                self._track(st, pos, 0)
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in where:
                self._track(st, pos, st.nbytes())
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops[pos] += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or packet in _NO_KERNEL or not (ins or outs):
            return out
        dev = (ins or outs)[0].device
        if any(t.device != dev for t in ins + outs) or self._between(packet, args, pos):
            return out  # a copy between devices or positions: counted where it is made
        skip = [args[0]] if packet in _WRITE_ONLY and args else []
        skip += _tensors((kwargs.get("out"),))
        seen = {id(t) for t in skip}
        n = 0
        for t in ins:
            if id(t) not in seen:
                seen.add(id(t))
                n += t.numel() * t.element_size()
        seen = set()
        for t in outs:
            if id(t) not in seen:
                seen.add(id(t))
                n += t.numel() * t.element_size()
        self.bytes[pos] += n
        self.by_op[packet] += n
        return out

    def kernel(self, name: str, flops: float, nbytes: float, like: torch.Tensor) -> None:
        if self.paused:
            return
        pos = self._position(like)
        k = self.kernels.setdefault(name, {"calls": [0] * self.positions,
                                           "flops": [0] * self.positions,
                                           "bytes": [0] * self.positions})
        k["calls"][pos] += 1
        k["flops"][pos] += int(flops)
        k["bytes"][pos] += int(nbytes)

    def moved(self, kind: str, src, dst: int, nbytes: int) -> None:
        if isinstance(src, torch.Tensor):
            src = self._held_at(src)
            src = 0 if src is None else src
        if src == dst or not nbytes:
            return
        self.colls[kind]["count"][dst] += 1
        self.colls[kind]["bytes"][dst] += nbytes
        self.sent[src] += nbytes
        self.received[dst] += nbytes
        self.pairs[(src, dst)] += nbytes

    def summary(self) -> dict:
        """The counts by position: ``flops`` and ``bytes`` (the torch ops'
        and the hand kernels' together), ``moved`` (the larger of sent
        and received), ``peak`` (live bytes the step allocated), the hand
        kernels' ``kernels`` and the moves' ``colls`` by kind (received);
        ``pairs``: ``[from, to, bytes]`` of the moves by pair of positions;
        ``end``: the live bytes the step still held when the count ended
        (its outputs, where the caller kept them)."""
        n = self.positions
        kflops = [sum(k["flops"][p] for k in self.kernels.values()) for p in range(n)]
        kbytes = [sum(k["bytes"][p] for k in self.kernels.values()) for p in range(n)]
        return {
            "flops": [a + b for a, b in zip(self.flops, kflops)],
            "bytes": [a + b for a, b in zip(self.bytes, kbytes)],
            "moved": [max(a, b) for a, b in zip(self.sent, self.received)],
            "peak": list(self.peak),
            "end": list(self.end),
            "kernels": {name: {k: list(v) for k, v in d.items()} for name, d in self.kernels.items()},
            "colls": {kind: {k: list(v) for k, v in d.items()} for kind, d in self.colls.items()},
            "pairs": [[src, dst, n] for (src, dst), n in sorted(self.pairs.items())],
        }


def extrapolate(a, b, steps: float):
    """``a + steps · (b − a)`` through a :meth:`CostCounter.summary` (ints
    stay ints): the counts of a run whose loop ran ``steps`` more
    iterations than ``a``'s, ``b``'s one more."""
    if isinstance(a, dict):
        return {k: extrapolate(a[k], b[k], steps) for k in a}
    if isinstance(a, list):
        return [extrapolate(x, y, steps) for x, y in zip(a, b)]
    return a + steps * (b - a)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_detail: dict
    model_flops_global: float
    arg_bytes_per_chip: float = 0.0
    temp_bytes_per_chip: float = 0.0
    out_bytes_per_chip: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def utility_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the counted compute is 'useful'."""
        counted = self.flops_per_chip * self.chips
        return self.model_flops_global / counted if counted else float("nan")

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            dominant=self.dominant,
            utility_ratio=self.utility_ratio,
        )
        return d


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for forward-only (prefill / decode)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def active_params(params: mdl.LM, cfg) -> tuple[int, int]:
    """(total, active) parameter counts; MoE experts count at top_k/n_routed.
    Summed over the reference's stacked leaves in its order, so the float
    sum rounds as the reference's."""
    named = dict(params.named_parameters())
    total = 0
    active = 0.0
    for path, names in mdl.reference_leaves(params):
        size = sum(named[n].numel() for n in names)
        total += size
        if cfg.moe is not None and path[-1] in ("e_gate", "e_up", "e_down"):
            active += size * (cfg.moe.top_k / cfg.moe.n_routed)
        else:
            active += size
    return total, int(active)
