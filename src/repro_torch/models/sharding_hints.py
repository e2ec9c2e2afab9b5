"""Activation-sharding hints, as the reference's model code states them.

Port of ``src/repro/models/sharding_hints.py``. The reference places
``constrain(x, "dp", None, "model", ...)`` on its big attention and MoE
intermediates, and the launch layer resolves the tokens "dp" / "model"
against the active hint set (``with sharding_hints(...)``) into a
``PartitionSpec`` for GSPMD. Eager PyTorch has no GSPMD to hand the spec to,
so here :func:`constrain` is the identity on values, and :func:`spec_for`
gives the spec it stands for, resolved as the reference resolves it: a
token whose axes do not divide the dim, or exceed it, leaves the dim
unsplit. The port's model code places no hint (ROADMAP lever L8).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

_state = threading.local()


def _current():
    return getattr(_state, "hints", None)


@contextlib.contextmanager
def sharding_hints(dp_axes, model_axis: str = "model", *, mesh=None):
    """dp_axes: an axis name or tuple (``('pod', 'data')``) for the
    batch / sequence dims; ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`) gives the axes' sizes, as the
    reference's active mesh does."""
    prev = _current()
    _state.hints = (dp_axes, model_axis, mesh)
    try:
        yield
    finally:
        _state.hints = prev


def constrain(x, *dims):
    """dims entries: 'dp' | 'model' | None. The identity: the spec it
    stands for is ``spec_for(x.shape, *dims)``."""
    del dims
    return x


def spec_for(shape, *dims) -> Optional[tuple]:
    """The spec the reference's ``constrain`` hands to
    ``with_sharding_constraint`` for a tensor of ``shape``; None when no
    hints are active (the reference then hands nothing)."""
    hints = _current()
    if hints is None:
        return None
    dp, model, mesh = hints
    sizes = None if mesh is None else mesh.shape
    spec = []
    for d, size in zip(dims, shape):
        axes = dp if d == "dp" else model if d == "model" else None
        n = _axes_size(sizes, axes) if axes is not None else None
        spec.append(axes if n and size % n == 0 and size >= n else None)
    return tuple(spec)


def _axes_size(sizes, axes):
    if sizes is None:
        return None
    if isinstance(axes, str):
        return sizes.get(axes)
    if any(a not in sizes for a in axes):
        return None
    return math.prod(sizes[a] for a in axes)
