"""Resolution of the ``device=`` argument every entry point takes."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if CUDA is asked for and absent.

    There is no fallback: a caller that wants the CPU passes ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev


def resolve_or_meta(device: "str | torch.device" = "cuda") -> torch.device:
    """:func:`resolve_device`, plus ``meta`` for building shapes without memory."""
    return torch.device("meta") if str(device) == "meta" else resolve_device(device)
