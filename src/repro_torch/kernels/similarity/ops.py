"""Pairwise client distances through the CUDA similarity kernel.

Port of ``src/repro/kernels/similarity/ops.py``. :func:`pairwise_sums` is
the kernel's wrapper: for a CUDA tensor it launches
``csrc/similarity.cu`` (Gram or L1 over the i ≤ j triangle, one 8 × 4
block of it a lane; d split across blocks by :func:`split_plan` and the
splits added in a fixed grouped order by a second kernel, or, where the
plan has one split, 4 × 4 a lane written straight to the output by the one
launch), for a CPU tensor it runs the plain version in ``ref.py``. The
reference's two Pallas kernels (the padded
one-shot ``pairwise_kernel`` and the masked ``pairwise_kernel_fused``)
compute the same function, so both entry points below,
:func:`pairwise_distances_device` and :func:`pairwise_distances_streamed`,
launch the one CUDA kernel; :func:`make_distance_fn` keeps the
reference's ``STREAM_D_THRESHOLD`` switch between them.
:func:`pairwise_distances_chunked` is the reference's host-side d-chunk
loop: a host G goes to the card one (n, ≤ d_chunk) slab at a time, one
launch a slab, so the card never holds the whole block.
:func:`resolve_distance_backend` maps the reference's backend names to
these. :func:`work` is a
call's operations and bytes; a meta input returns an empty meta output,
and every route adds the call's work to the dry-run's running count
(``_build.count_kernel``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.similarity.ref import (
    _zero_diag_symmetrize,
    distances_from_gram,
    gram_ref,
    l1_ref,
)

#: d above which the "auto" backend takes the streamed entry point.
STREAM_D_THRESHOLD = 8192

#: As in ``csrc/similarity.cu``: d is walked in chunks of BK columns (a
#: ragged last chunk is zero-filled); a lane owns an 8 × 4 block of the
#: triangle and a block a pair of TILE-row tiles of them (4 × 4 blocks in
#: 16-row tiles in a one-split call, see :func:`lane_tile`).
TILE = 128
BK = 32
#: Blocks the d-split aims for: two per SM of a 132-SM H100, as many as
#: its registers hold at once. A constant, not the card's SM count, so the
#: split (and the bits) are the same on every card.
TARGET_BLOCKS = 264
#: Chunks a split takes at least: below 2·MIN_CHUNKS chunks a call is one
#: split and one launch.
MIN_CHUNKS = 4
#: The reduction adds each group of GROUP splits in split order, then the
#: group sums in group order; at most MAX_SPLITS splits.
GROUP = 8
MAX_SPLITS = 512

_OPS = {"gram": 0, "l1": 1}

#: Kernel launches per op since the count was last reset; a launch is one
#: call of the C entry point (the partial pass, and the reduce pass where
#: the plan has more than one split).
launches = {"gram": 0, "l1": 0}


def split_plan(n: int, d: int) -> tuple[int, int]:
    """(splits, chunks per split) of the d axis for an (n, d) input.

    About TARGET_BLOCKS blocks over the tile pairs and at most MAX_SPLITS
    splits; split s takes chunks [s·per, (s+1)·per) with per ≥ MIN_CHUNKS
    where there are two splits or more, and none is empty. A function of
    (n, d) only.
    """
    n_tiles = -(-n // TILE)
    n_pairs = n_tiles * (n_tiles + 1) // 2
    n_chunks = -(-d // BK)
    splits = max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // n_pairs), n_chunks // MIN_CHUNKS))
    per = -(-n_chunks // splits)
    return -(-n_chunks // per), per


def lane_tile(splits: int) -> int:
    """Rows of the block of the triangle one lane owns: 8 (an 8 × 4 block),
    or 4 (4 × 4) in a one-split call, whose time is latency rather than
    issue (the kernel then cuts the rows in 16-row tiles: more blocks,
    fewer sums a lane)."""
    return 4 if splits == 1 else 8


def work(n: int, d: int, op: str) -> tuple[int, int]:
    """(operations, bytes) of an (n, d) call over the i <= j half: the
    Gram's FFMA 2 FLOP a product, L1's two FP32-pipe instructions (a − b,
    acc + |·|) 4 FLOP an element at the f32 peak; G read once, the (n, n)
    output written once."""
    return (2 if op == "l1" else 1) * n * (n + 1) * d, 4 * (n * d + n * n)


@functools.cache
def _lib():
    """The similarity library, with its C signature bound once."""
    lib = _build.load("similarity")
    lib.pairwise_sums.restype = ctypes.c_int
    lib.pairwise_sums.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.pairwise_scratch_floats.restype = ctypes.c_longlong
    lib.pairwise_scratch_floats.argtypes = [ctypes.c_int] * 2
    return lib


def pairwise_sums(G: torch.Tensor, op: str) -> torch.Tensor:
    """G (n, d) f32 -> (n, n): the Gram matrix (``op="gram"``) or L1 sums."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; choose gram | l1")
    if G.dim() != 2 or G.shape[0] < 1 or G.shape[1] < 1:
        raise ValueError(f"G must be (n, d) with n, d >= 1, got {tuple(G.shape)}")
    if G.dtype != torch.float32:
        raise TypeError(f"G must be float32, got {G.dtype}")
    if G.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {G.device}")
    _build.count_kernel(op, *work(*G.shape, op), G)
    if G.device.type == "meta":
        return torch.empty((G.shape[0], G.shape[0]), dtype=torch.float32, device=G.device)
    if G.device.type == "cpu":
        with _build.uncounted():
            return gram_ref(G) if op == "gram" else l1_ref(G)
    if not G.is_contiguous():
        raise ValueError("G must be contiguous")
    n, d = G.shape
    splits, per = split_plan(n, d)
    ts = lane_tile(splits)
    lib = _lib()
    out = torch.empty((n, n), dtype=torch.float32, device=G.device)
    # each split's sums, lane by lane; one split writes `out` itself
    partial = (torch.empty((splits, lib.pairwise_scratch_floats(n, ts)), dtype=torch.float32,
                           device=G.device) if splits > 1 else None)
    # the C entry point launches (and opts in to its shared memory) on the
    # current device: make it G's
    with torch.cuda.device(G.device):
        err = lib.pairwise_sums(
            G.data_ptr(),
            None if partial is None else partial.data_ptr(),
            out.data_ptr(),
            n,
            d,
            _OPS[op],
            splits,
            per,
            ts,
            torch.cuda.current_stream(G.device).cuda_stream,
        )
    _build.check(lib, err, f"similarity kernel ({op})")
    launches[op] += 1
    _build.tally(op)
    return out


def _check_measure(measure: str) -> str:
    """The kernel op of a measure: ``"l1"``, or ``"gram"`` for arccos and l2."""
    if measure not in ("arccos", "l2", "l1"):
        raise ValueError(f"unknown measure {measure!r}")
    return "l1" if measure == "l1" else "gram"


def _from_sums(acc: torch.Tensor, measure: str) -> torch.Tensor:
    """(n, n) distances from the kernel's Gram or L1 sums."""
    if measure == "l1":
        return _zero_diag_symmetrize(acc)
    return distances_from_gram(acc, measure)


def pairwise_distances_device(G, measure: str = "arccos") -> torch.Tensor:
    """(n, d) representative gradients -> (n, n) distance matrix."""
    op = _check_measure(measure)
    G = torch.as_tensor(G).to(torch.float32).contiguous()
    return _from_sums(pairwise_sums(G, op), measure)


def pairwise_distances_streamed(G, measure: str = "arccos") -> torch.Tensor:
    """(n, d) -> (n, n) distances for model-sized d, G on its device.

    The same kernel launch as :func:`pairwise_distances_device`: the kernel
    streams d in 32-column chunks through shared memory and splits it
    across blocks, so G is never padded whatever its width. The reference's two
    entry points differ (padded one-shot vs masked streaming); here the
    switch in :func:`make_distance_fn` only keeps the reference's shape, and
    the reference's ``d_chunk``, which capped its tile width, has nothing to
    cap. For a G that lives on the host, :func:`pairwise_distances_chunked`
    moves it to the card a slab at a time.
    """
    return pairwise_distances_device(G, measure)


def pairwise_distances_chunked(G, measure: str = "arccos", *, d_chunk: int = STREAM_D_THRESHOLD,
                               device=None) -> torch.Tensor:
    """(n, d) -> (n, n) distances, summed over host-side ``d``-chunks.

    G is a host numpy array or a tensor. Each (n, ≤ d_chunk) slab is copied
    to ``device`` (default: a tensor G's own device, the card for a numpy
    G) as f32 and summed by one :func:`pairwise_sums` call; the Gram and L1
    sums add exactly over coordinates, so only the slab ever lives on the
    device, and a host G larger than the card's free memory works. The
    slabs' sums are added in chunk order in f32, as the reference's loop
    adds them.
    """
    op = _check_measure(measure)
    n, d = G.shape
    if d == 0:
        raise ValueError("need at least one gradient coordinate")
    if device is None and isinstance(G, torch.Tensor):
        device = G.device
    dev = resolve_device("cuda" if device is None else device)
    d_chunk = max(int(d_chunk), 1)
    acc = None
    for lo in range(0, d, d_chunk):
        if isinstance(G, torch.Tensor):
            slab = G[:, lo: lo + d_chunk].to(device=dev, dtype=torch.float32).contiguous()
        else:
            slab = torch.from_numpy(np.ascontiguousarray(G[:, lo: lo + d_chunk], np.float32))
            slab = slab.to(dev)
        part = pairwise_sums(slab, op)
        acc = part if acc is None else acc.add_(part)
        del slab
    return _from_sums(acc, measure)


def make_distance_fn(*, streamed: bool = False, d_chunk: int = STREAM_D_THRESHOLD,
                     chunked: bool = False, as_numpy: bool = False):
    """Adapter matching ``repro_torch.core.samplers.algorithm2.DistanceFn``:
    (G, measure) -> (n, n) distances.

    The one-shot entry point is used up to ``d_chunk`` coordinates and the
    streamed one beyond it (or always, with ``streamed``); ``chunked`` takes
    :func:`pairwise_distances_chunked` instead, with ``d_chunk`` its slab
    width (a tensor G's slabs stay on its device, a host G's go to the
    card). By default the distances stay a tensor on G's device (``"ward"``
    copies them to the host, ``"ward_jit"`` does not); ``as_numpy`` returns a
    host numpy copy, as the reference's default does. Only ``chunked`` takes a host G: in the other modes a host array
    would reach the plain version on the CPU with the card idle, so ``fn``
    raises on one instead of converting.
    """

    def fn(G, measure: str):
        if chunked:
            out = pairwise_distances_chunked(G, measure, d_chunk=d_chunk)
        elif not isinstance(G, torch.Tensor):
            raise TypeError(
                f"distance op needs G as a torch tensor on its device, got "
                f"{type(G).__name__}; move host arrays to the store's device "
                "first (torch.as_tensor(G, device=...)), or take the chunked backend"
            )
        elif streamed or G.shape[1] > d_chunk:
            out = pairwise_distances_streamed(G, measure)
        else:
            out = pairwise_distances_device(G, measure)
        return out.cpu().numpy() if as_numpy else out

    return fn


#: The reference's device backend names and their :func:`make_distance_fn`
#: modes. ``auto``, ``pallas`` and ``pallas-interpret`` chose among Pallas
#: builds of one function; here they are all the one CUDA kernel (on a CUDA
#: G; the plain version on a CPU G).
_MODES = {"auto": {}, "pallas": {}, "pallas-interpret": {}, "streamed": {"streamed": True},
          "chunked": {"chunked": True}}
DISTANCE_BACKENDS = (*_MODES, "numpy")


def _host_distances(G, measure: str) -> np.ndarray:
    """The f64 host measure (:func:`repro_torch.core.clustering.similarity.
    pairwise_distances`) on a host copy of ``G``, tensor or numpy."""
    from repro_torch.core.clustering.similarity import pairwise_distances

    if isinstance(G, torch.Tensor):
        G = G.cpu().numpy()
    return pairwise_distances(G, measure)


def resolve_distance_backend(backend: str = "auto", *, as_numpy: bool = True):
    """Pick the pairwise-distance backend for Algorithm 2's O(n²d) stage.

    * ``"auto"``, ``"pallas"``, ``"pallas-interpret"`` — the similarity
      kernel, one-shot up to :data:`STREAM_D_THRESHOLD` coordinates and
      streamed beyond (the same launch here);
    * ``"streamed"`` — always the streamed entry point;
    * ``"chunked"`` — :func:`pairwise_distances_chunked`, the one backend
      that takes a host G (moved to the card a slab at a time);
    * ``"numpy"`` — the f64 host measure, on a host copy of G.

    ``as_numpy=False`` keeps the device backends' output on G's device (the
    numpy measure is host-side either way).
    """
    if backend == "numpy":
        return _host_distances
    if backend not in _MODES:
        raise ValueError(
            f"unknown distance backend {backend!r}; choose from {' | '.join(DISTANCE_BACKENDS)}"
        )
    return make_distance_fn(as_numpy=as_numpy, **_MODES[backend])
