"""Sketch stage: the ``SKETCHERS`` registry and the CUDA SRP kernel's wrapper.

Port of ``src/repro/kernels/sketch/ops.py``. The gradient store compresses
each incoming representative gradient from the model dimension ``d`` to a
sketch dimension ``d_prime`` before the scatter, so the resident buffer and
everything the plan rebuild touches scale in ``d_prime``:

    sketcher = SKETCHERS.get(name)(d_in, d_prime, seed=0)
    y = sketcher(x)

Built-ins:

* ``"identity"`` returns its input object unchanged: a store with
  ``sketch="identity"`` is bit for bit the unsketched store.
* ``"srp"`` is the signed random projection through :func:`srp_sketch`,
  which launches ``csrc/sketch.cu`` for a CUDA tensor and runs the plain
  version in ``ref.py`` for a CPU tensor.
* ``"countsketch"`` is the seeded counting sketch, in torch ops on either
  device (``ref.sketch_countsketch_plain``), summed without float atomics
  so that it is bit-reproducible on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.registry import Registry
from repro_torch.kernels import _build
from repro_torch.kernels.sketch.ref import (
    _host,
    seed_term,
    sketch_countsketch_plain,
    sketch_countsketch_reference,
    sketch_srp_plain,
    sketch_srp_reference,
    srp_scale,
)

#: d-block of the plain SRP version; it fixes only that version's summation
#: order (the kernel's split is its own, see :func:`split_plan`).
SKETCH_BLOCK_D = 512

#: The kernel's k-tile and column tile, as in ``csrc/sketch.cu``.
TK = 64
TJ = 64
#: Splits of the d axis once d has that many k-tiles: a constant, not the
#: card's SM count, so the split (and the bits) are the same on every card.
SPLITS = 128
#: Split counts are a multiple of this: the reduction adds each group of
#: GROUP splits in order, then the group sums in order.
GROUP = 8

#: Kernel launches since the count was last reset; a launch is one call of
#: the C entry point.
launches = {"srp": 0}


def split_plan(d: int) -> tuple[int, int]:
    """(splits, k-tiles per split) of the d axis.

    ``SPLITS`` splits, or the multiple of ``GROUP`` at or above the k-tile
    count when d has fewer; each takes ``per`` k-tiles of ``TK`` columns in
    order, and a split past the end sums nothing. A function of d only, never
    of the row count: a row's sketch is the same bits whatever rows share the
    call.
    """
    n_tiles = -(-d // TK)
    splits = SPLITS if n_tiles >= SPLITS else GROUP * -(-n_tiles // GROUP)
    return splits, -(-n_tiles // splits)


def work(c: int, d: int, d_prime: int) -> tuple[int, int]:
    """(operations, bytes) of a (c, d) -> (c, d') call: X · S at 2 FLOP a
    multiply-add; X read once, Y written once (S is regenerated from the
    hash, never read)."""
    return 2 * c * d * d_prime, 4 * (c * d + c * d_prime)


@functools.lru_cache(maxsize=64)
def _launch_args(d: int, d_prime: int, seed: int) -> tuple[int, float, int, int]:
    """(seed_term, scale, splits, per) of a call: fixed per (d, d', seed)."""
    return (seed_term(seed), srp_scale(d_prime), *split_plan(d))


@functools.cache
def _lib():
    """The sketch library, with its C signature bound once."""
    lib = _build.load("sketch")
    lib.srp_sketch.restype = ctypes.c_int
    lib.srp_sketch.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 3
        + [ctypes.c_uint32, ctypes.c_float]
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    lib.srp_smem_bytes.restype = ctypes.c_int
    lib.srp_smem_bytes.argtypes = [ctypes.c_int]
    return lib


def smem_bytes(c: int) -> int:
    """Dynamic shared memory of a partial-pass block for a call with c rows."""
    return _lib().srp_smem_bytes(int(c))


def srp_sketch(X: torch.Tensor, d_prime: int, seed: int, *, block_d: int = SKETCH_BLOCK_D) -> torch.Tensor:
    """X (c, d) f32 -> (c, d_prime) f32, Y = X · S with S regenerated from the hash.

    ``block_d`` is the plain version's d-block on a CPU tensor; the kernel
    ignores it.
    """
    d_prime = int(d_prime)
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X must be (c, d) with c, d >= 1, got {tuple(X.shape)}")
    if d_prime < 1:
        raise ValueError(f"d_prime must be >= 1, got {d_prime}")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")
    if X.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {X.device}")
    _build.count_kernel("srp", *work(*X.shape, d_prime), X)
    if X.device.type == "meta":
        return torch.empty((X.shape[0], d_prime), dtype=torch.float32, device=X.device)
    if X.device.type == "cpu":
        with _build.uncounted():
            return sketch_srp_plain(X, d_prime, seed, block_d=block_d)
    if not X.is_contiguous():
        raise ValueError("X must be contiguous")
    c, d = X.shape
    term, scale, splits, per = _launch_args(d, d_prime, int(seed))
    partial = torch.empty((splits, c, d_prime), dtype=torch.float32, device=X.device)
    out = torch.empty((c, d_prime), dtype=torch.float32, device=X.device)
    lib = _lib()
    # the C entry point launches (and opts in to its shared memory) on the
    # current device: make it X's
    with torch.cuda.device(X.device):
        err = lib.srp_sketch(
            X.data_ptr(),
            partial.data_ptr(),
            out.data_ptr(),
            c,
            d,
            d_prime,
            term,
            scale,
            splits,
            per,
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _build.check(lib, err, "srp sketch kernel")
    launches["srp"] += 1
    _build.tally("srp")
    return out


class Sketcher:
    """A fitted sketch: ``d_in`` model coordinates -> ``d_out`` sketch ones.

    The projection is a pure function of ``(name, d_in, d_out, seed)``, so a
    sketcher rebuilt from those four values applies the identical
    compression. ``__call__`` takes tensors on their device;
    :meth:`reference` is the numpy host path (a tensor is copied to the
    host first) and returns numpy.
    """

    name = "base"

    def __init__(self, d_in: int, d_out: int, seed: int):
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.seed = int(seed)

    def __call__(self, X):
        raise NotImplementedError

    def reference(self, X) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(d_in={self.d_in}, d_out={self.d_out}, seed={self.seed})"


class IdentitySketcher(Sketcher):
    """The unsketched path: X comes back untouched (the same object)."""

    name = "identity"

    def __call__(self, X):
        return X

    def reference(self, X) -> np.ndarray:
        return X if isinstance(X, np.ndarray) else _host(X)


class SRPSketcher(Sketcher):
    """Signed random projection: the CUDA kernel on the card, the plain
    version on the CPU. ``block_d`` fixes only the plain version's
    summation order."""

    name = "srp"

    def __init__(self, d_in: int, d_out: int, seed: int, block_d: int = SKETCH_BLOCK_D):
        super().__init__(d_in, d_out, seed)
        self.block_d = int(block_d)

    def __call__(self, X):
        return srp_sketch(X, self.d_out, self.seed, block_d=self.block_d)

    def reference(self, X) -> np.ndarray:
        return sketch_srp_reference(X, self.d_out, self.seed, block_d=self.block_d)


class CountSketcher(Sketcher):
    """Seeded counting sketch: one bucket and sign per input coordinate."""

    name = "countsketch"

    def __call__(self, X):
        return sketch_countsketch_plain(X, self.d_out, self.seed)

    def reference(self, X) -> np.ndarray:
        return sketch_countsketch_reference(X, self.d_out, self.seed)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
def _need_dim(name: str, d_prime: Optional[int], d_in: int) -> int:
    if d_prime is None:
        raise ValueError(
            f"sketcher {name!r} needs a sketch dimension; pass sketch_dim "
            "(GradientStore(sketch_dim=...))"
        )
    d_prime = int(d_prime)
    if not 1 <= d_prime <= d_in:
        raise ValueError(f"sketch_dim must satisfy 1 <= d_prime <= d={d_in}, got {d_prime}")
    return d_prime


def make_identity(d_in: int, d_prime: Optional[int] = None, *, seed: int = 0):
    if d_prime is not None and int(d_prime) != int(d_in):
        raise ValueError(
            f"sketch 'identity' keeps every coordinate; sketch_dim={d_prime} "
            f"!= update_dim={d_in} — drop sketch_dim or pick a compressing "
            "sketcher ('srp', 'countsketch')"
        )
    return IdentitySketcher(d_in, d_in, seed)


def make_srp(d_in: int, d_prime: Optional[int] = None, *, seed: int = 0):
    return SRPSketcher(d_in, _need_dim("srp", d_prime, d_in), seed)


def make_countsketch(d_in: int, d_prime: Optional[int] = None, *, seed: int = 0):
    return CountSketcher(d_in, _need_dim("countsketch", d_prime, d_in), seed)


#: name -> sketcher factory ``(d_in, d_prime, seed=0) -> Sketcher``.
SKETCHERS = Registry(
    "sketcher",
    {
        "identity": make_identity,
        "srp": make_srp,
        "countsketch": make_countsketch,
    },
)

register_sketcher = SKETCHERS.register


def resolve_sketcher(
    sketch: Union[str, Sketcher, None],
    d_in: int,
    d_prime: Optional[int] = None,
    *,
    seed: int = 0,
) -> Optional[Sketcher]:
    """Map a sketch argument to a fitted :class:`Sketcher` (or ``None``).

    ``None`` means no sketch stage at all; a string names a
    :data:`SKETCHERS` entry; a fitted :class:`Sketcher` passes through after
    a dimension check.
    """
    if sketch is None:
        return None
    if isinstance(sketch, Sketcher):
        if sketch.d_in != int(d_in):
            raise ValueError(f"sketcher expects d_in={sketch.d_in}, store has update_dim={d_in}")
        return sketch
    return SKETCHERS.get(sketch)(d_in, d_prime, seed=seed)
