"""The local step's model in plain float32 PyTorch, and its parameter layout.

One dense decoder LM over the configuration's published widths: token
embedding, pre-norm blocks (RMS norm; GQA attention with q/k/v bias and
interleaved RoPE; a SwiGLU MLP), a final RMS norm, the (tied or not) head
and a next-token cross-entropy.
Every product runs in float32 with TF32 off (:func:`strict_f32`); each
block and each chunk of the head is recomputed in the backward pass
(``torch.utils.checkpoint``), so one client's step fits beside the rest.

``quant="fp8"`` is the control: every matrix product's two operands pass
through float8 e4m3 with a per-tensor scale (amax to 448) before a float32
product, the gradient passing straight through; it stands for the
program computed one precision below the bf16 it is configured for.

The flat layout (:func:`flat_leaves`) is the stacked tree's: leaves sorted
by key at every level; a stacked leaf lists its layers one after another.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.spec import Arch

NEG = -1.0e30
CE_CHUNK = 512


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# --------------------------------------------------------------------------
# parameter layout
# --------------------------------------------------------------------------
def _block_leaves(a: Arch) -> list:
    d, h, kv, hd = a.d_model, a.n_heads, a.n_kv_heads, a.head_dim

    def normal(fan_in):
        return ("normal", fan_in ** -0.5)

    out = [
        (("norm1", "scale"), (d,), ("ones",)),
        (("attn", "wq"), (d, h * hd), normal(d)),
        (("attn", "wk"), (d, kv * hd), normal(d)),
        (("attn", "wv"), (d, kv * hd), normal(d)),
        (("attn", "wo"), (h * hd, d), normal(h * hd)),
        (("ffn_norm", "scale"), (d,), ("ones",)),
        (("mlp", "w_up"), (d, a.d_ff), normal(d)),
        (("mlp", "w_down"), (a.d_ff, d), normal(a.d_ff)),
        (("mlp", "w_gate"), (d, a.d_ff), normal(d)),
    ]
    if a.qkv_bias:
        out += [(("attn", b), (w,), ("zeros",))
                for b, w in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd))]
    return sorted(out, key=lambda leaf: leaf[0])


def flat_leaves(a: Arch) -> list:
    """(name, shape, init) of every parameter, in the flat vector's order."""
    d, v = a.d_model, a.vocab
    out = [("embed", (v, d), ("normal", d ** -0.5)), ("final_norm.scale", (d,), ("ones",))]
    if not a.tie:
        out.append(("lm_head", (d, v), ("normal", d ** -0.5)))
    for p, s, init in _block_leaves(a):
        out += [(f"blocks.{i}." + ".".join(p), s, init) for i in range(a.n_layers)]
    return out


def views(flat: torch.Tensor, leaves) -> dict:
    """name -> a view of ``flat`` shaped as the leaf."""
    out, off = {}, 0
    for name, shape, _ in leaves:
        n = 1
        for s in shape:
            n *= s
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def leaf_runs(leaves) -> list:
    """(name, offset, numel) of each leaf in the flat vector."""
    out, off = [], 0
    for name, shape, _ in leaves:
        n = 1
        for s in shape:
            n *= s
        out.append((name, off, n))
        off += n
    return out


# --------------------------------------------------------------------------
# the fp8 control's quantisation
# --------------------------------------------------------------------------
class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class Model:
    """The local step's loss over parameters given as named tensors."""

    def __init__(self, a: Arch, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.a = a
        self.quant = quant

    # -- products -------------------------------------------------------------
    def _q(self, x):
        return _FP8.apply(x) if self.quant else x

    def mm(self, x, w):
        return self._q(x) @ self._q(w)

    def ein(self, eq, x, y):
        return torch.einsum(eq, self._q(x), self._q(y))

    # -- layers ----------------------------------------------------------------
    def rms(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.a.eps) * scale

    def angles(self, s: int, dim: int, device):
        inv = 1.0 / (torch.tensor(self.a.rope_theta, dtype=torch.float32, device=device)
                     ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
        return torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv

    @staticmethod
    def rope(x, ang):
        """Rotate the interleaved pairs (x[2i], x[2i+1]); x (B, S, H, D)."""
        x1, x2 = x[..., 0::2], x[..., 1::2]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).reshape(x.shape)

    def attention(self, P, h):
        a = self.a
        b, s, _ = h.shape
        H, KV, hd = a.n_heads, a.n_kv_heads, a.head_dim
        q, k, v = self.mm(h, P["attn.wq"]), self.mm(h, P["attn.wk"]), self.mm(h, P["attn.wv"])
        if a.qkv_bias:
            q, k, v = q + P["attn.bq"], k + P["attn.bk"], v + P["attn.bv"]
        ang = self.angles(s, hd, h.device)
        q = self.rope(q.reshape(b, s, H, hd), ang).reshape(b, s, KV, H // KV, hd)
        k = self.rope(k.reshape(b, s, KV, hd), ang)
        v = v.reshape(b, s, KV, hd)
        sc = self.ein("bskgh,btkh->bkgst", q, k) * hd ** -0.5
        mask = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
        p = torch.softmax(torch.where(mask, sc, NEG), dim=-1)
        out = self.ein("bkgst,btkh->bskgh", p, v).reshape(b, s, H * hd)
        return self.mm(out, P["attn.wo"])

    def mlp(self, P, h):
        return self.mm(F.silu(self.mm(h, P["mlp.w_gate"])) * self.mm(h, P["mlp.w_up"]),
                       P["mlp.w_down"])

    def block(self, P, i, x):
        pre = {k[len(f"blocks.{i}."):]: t for k, t in P.items() if k.startswith(f"blocks.{i}.")}
        x = x + self.attention(pre, self.rms(x, pre["norm1.scale"]))
        return x + self.mlp(pre, self.rms(x, pre["ffn_norm.scale"]))

    def _ce_chunk(self, head, h, t):
        logp = torch.log_softmax(self.mm(h, head), dim=-1)
        return -logp.gather(-1, t[..., None]).sum()

    def loss(self, P: dict, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Mean next-token CE over (B, S)."""
        a = self.a
        x = F.embedding(tokens, P["embed"])
        for i in range(a.n_layers):
            x = checkpoint(self.block, P, i, x, use_reentrant=False)
        x = self.rms(x, P["final_norm.scale"])
        head = P["embed"].T if a.tie else P["lm_head"]
        b, s, _ = x.shape
        ce = torch.zeros((), device=x.device)
        for lo in range(0, s, CE_CHUNK):
            ce = ce + checkpoint(self._ce_chunk, head, x[:, lo:lo + CE_CHUNK],
                                 targets[:, lo:lo + CE_CHUNK], use_reentrant=False)
        return ce / (b * s)
