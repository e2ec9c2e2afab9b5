"""Causal GQA attention through the CUDA flash kernels.

Port of ``src/repro/kernels/flash_attention/ops.py``.
:func:`flash_attention_padded` is the kernels' wrapper: for CUDA tensors it
launches ``csrc/flash_attention.cu``, for CPU tensors it runs the plain
version in ``ref.py``. The source holds four kernels, chosen by dtype and
head dim alone: bf16 and f16 at 32 < hd <= 128 (every model path's) go to
``flash_fwd_wgmma`` (wgmma, TMA and an mbarrier ring), at hd <= 32 and up
to 256 to ``flash_fwd_mma`` (mma.sync), above 256 to ``flash_fwd_mma_wide``
(the output's head dim cut into 128-column chunks); f32 goes to
``flash_fwd_f32`` on the CUDA cores (TF32 would break the f32 parity at
atol 2e-5). q, k and v of mixed dtypes
go to ``flash_fwd_f32`` too, instantiated on v's dtype (p is rounded to it
before the PV product) and q's (the output's), with q and k widened to f32
by exact copies. They take the true S and T
and mask the ragged tails themselves, so nothing is padded: q, k and v are
read in their (B, S, H, hd) and (B, T, KV, hd) layouts by strides, and the
output is written (B, S, H, hd). As the reference does, they take any head
dim, any B and H, and any view: the wgmma kernel loads an operand by TMA
where its base and strides are multiples of 16 bytes, the bf16 and f16
kernels copy it 16, 8, 4 or 2 bytes at a time where they are not, with the
same products either way. The wrapper copies an operand whose
head-dim stride is not 1 (contiguous) and, for mixed dtypes, a 16-bit q or
k (widened to f32); neither copy counts as the function's work. The
reference's ``block_q`` / ``block_k`` / ``interpret`` arguments choose
Pallas tiles and interpret mode; the CUDA tiles are fixed in the source, so
the port has no such arguments.

:func:`flash_attention` is the differentiable route the model calls: a
``torch.autograd.Function`` whose forward is :func:`flash_attention_padded`
(the kernel for CUDA tensors, the plain version for CPU tensors) and whose
backward is ``backward.flash_attention_bwd`` on either device.

:func:`work` is a call's operations and bytes, which the bounds and the
dry-run's counts use; a meta input returns an empty meta output and adds
that work to the running count (``_build.count_kernel``), as every route
does once a call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

#: Kernel launches since the count was last reset.
launches = {"flash_attention": 0}

#: The C entry points' dtype codes. One dtype for q, k and v takes
#: ``flash_attention_fwd`` (f32 → ``flash_fwd_f32``, bf16 and f16 → the
#: tensor-core kernels); mixed dtypes take ``flash_attention_fwd_mixed``
#: (``flash_fwd_f32`` on v's and q's codes, q and k widened to f32).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _lib():
    """The flash-attention library, with its C signature bound once."""
    return bind(_build.load("flash_attention"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C signatures of ``flash_attention_fwd`` and, where
    the library has it (an earlier source built by ``turns.py`` may not),
    ``flash_attention_fwd_mixed`` bound."""
    tail = [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + tail
    if hasattr(lib, "flash_attention_fwd_mixed"):
        lib.flash_attention_fwd_mixed.restype = ctypes.c_int
        lib.flash_attention_fwd_mixed.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + tail
    return lib


def work(b: int, s: int, t: int, h: int, kv: int, hd: int, *, causal: bool = True,
         itemsizes: tuple[int, int, int] = (4, 4, 4)) -> tuple[int, int]:
    """(operations, bytes) of a call: QKᵀ and PV, 2 FLOP a multiply-add,
    over the S × T scores, half of them when causal; q and the output, k
    and v each read or written once at q's, k's and v's own itemsize (the
    output at q's)."""
    flops = 4 * b * h * hd * s * t
    iq, ik, iv = itemsizes
    return flops // 2 if causal else flops, 2 * iq * b * s * h * hd + (ik + iv) * b * t * kv * hd


def _strides(a: torch.Tensor) -> list[int]:
    """The batch, sequence and head strides, 0 where the axis has size 1
    (its index is always 0, so its stride is never used)."""
    return [st if n > 1 else 0 for n, st in zip(a.shape[:3], a.stride()[:3])]


def flash_attention_padded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,hd), each f32, bf16 or f16 -> (B,S,H,hd) in q's dtype.

    Query head h reads kv head h // (H / KV). With ``causal`` query i sees
    keys j <= i; without it, every key j < T. Any hd >= 1 and any strides;
    on the card an operand whose head-dim stride is not 1 is read through a
    contiguous copy.

    The dtypes may differ, as in the reference: the scores are f32 dots of
    q and k (a bf16 or f16 operand widened exactly), p is rounded to v's
    dtype before the PV product, and the output is in q's dtype. Routes on
    the card: one dtype for all three takes its own kernel (f32 the CUDA
    cores, bf16 and f16 the tensor cores); any mix takes the f32 kernel,
    instantiated on v's dtype and q's, with a 16-bit q or k widened to f32
    first.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need 4-d q, k, v, got {q.dim()}, {k.dim()}, {v.dim()} dims")
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "are not (B,S,H,hd), (B,T,KV,hd), (B,T,KV,hd)")
    if min(b, s, t, h, kv, hd) < 1 or h % kv:
        raise ValueError(f"need B, S, T, H, KV, hd >= 1 and H % KV == 0, got {tuple(q.shape)}, "
                         f"KV={kv}")
    if not all(a.dtype in DTYPES for a in (q, k, v)):
        raise TypeError(f"need float32, bfloat16 or float16 for q, k and v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    device = q.device
    if not (device == k.device == v.device):
        raise ValueError(f"q on {device}, k on {k.device}, v on {v.device}")
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device}")
    if _build.counting():
        sizes = (q.element_size(), k.element_size(), v.element_size())
        _build.count_kernel("flash_attention", *work(b, s, t, h, kv, hd, causal=causal,
                                                     itemsizes=sizes), q)
    if device.type == "meta":
        return torch.empty((b, s, h, hd), dtype=q.dtype, device=device)
    if device.type == "cpu":
        with _build.uncounted():  # laid out (B, S, H, hd) as the kernel writes it
            return flash_attention_plain(q, k, v, causal=causal).contiguous()
    out = launch(_lib(), q, k, v, causal)
    launches["flash_attention"] += 1
    _build.tally("flash_attention")
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """One launch of ``lib``'s kernel (a library :func:`bind` has bound) on
    CUDA tensors that :func:`flash_attention_padded` has checked; counts
    nothing."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    device = q.device
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=device)
    mixed = not q.dtype == k.dtype == v.dtype
    if mixed or hd > 1 and not q.stride(3) == k.stride(3) == v.stride(3) == 1:
        with _build.uncounted():  # the wrapper's copies, not the function's work
            if mixed:  # exact: every bf16 and f16 value is an f32 value
                q, k = q.to(torch.float32), k.to(torch.float32)
            q, k, v = (a if a.stride(3) == 1 or hd == 1 else a.contiguous() for a in (q, k, v))
    codes = (DTYPES[v.dtype], DTYPES[out.dtype]) if mixed else (DTYPES[q.dtype],)
    entry = lib.flash_attention_fwd_mixed if mixed else lib.flash_attention_fwd
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *codes, b, s, t, h, kv, hd,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out), hd**-0.5, int(causal),
            torch._C._cuda_getCurrentRawStream(device.index))
    # the C entry point launches (and opts in to its shared memory) on the
    # current device: make it the tensors' where it is not. At the serve
    # shapes a call's host path takes longer than its kernel, so it stays
    # lean: no context switch, copy guard or stream object it does not need.
    if device.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(device):
            err = entry(*args)
    _build.check(lib, err, "flash attention kernel")
    return out


class FlashAttention(torch.autograd.Function):
    """Forward through :func:`flash_attention_padded`, backward through
    :func:`~repro_torch.kernels.flash_attention.backward.flash_attention_bwd`
    (P recomputed from the saved q and k)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_padded(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, dout, causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True):
    """:func:`flash_attention_padded` with a gradient for q, k and v."""
    return FlashAttention.apply(q, k, v, causal)
