"""The sketch stage of the gradient store (SRP kernel, countsketch, registry)."""
from repro_torch.kernels.sketch.ops import (
    SKETCHERS,
    Sketcher,
    register_sketcher,
    resolve_sketcher,
)

__all__ = ["SKETCHERS", "Sketcher", "register_sketcher", "resolve_sketcher"]
