"""RG-LRU recurrence + temporal conv (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``src/repro/models/layers/rglru.py``. The Real-Gated Linear
Recurrent Unit:

    r_t = sigmoid(x_t W_r + b_r)              (recurrence gate)
    i_t = sigmoid(x_t W_i + b_i)              (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)         (diagonal decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Prefill evaluates the diagonal linear recurrence with :func:`_assoc_scan`,
the odd/even recursion of ``jax.lax.associative_scan`` written in torch
ops: ⌈log₂ S⌉ levels of whole-tensor multiply-adds over (B, S, w), out of
place so autograd differentiates it, and the same pairings as the
reference's, so the f32 sums come out in its order. Decode is the O(1)
single-step update. The gates multiply by ``w_r`` and ``w_i`` in f32, as
the reference does, whatever the activation dtype.

The recurrent block wraps the RG-LRU with the Griffin structure:
x → (linear → conv1d(width 4) → RG-LRU) ⊙ gelu(linear) → out-proj. The
block's decode state is ``{"h": (B, w) f32, "conv": (B, cw - 1, w)}``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.mlp import ACTS

_A_SCALE = 8.0


def init_rglru_block(cfg: ModelConfig, gen: Optional[torch.Generator], device) -> dict:
    """The reference's leaves and scales, drawn from ``gen``."""
    d = cfg.d_model
    w = cfg.lru_width or cfg.d_model
    cw = cfg.rglru_conv_width

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    lam = torch.linspace(0.001, 0.1, w, dtype=torch.float32, device=device)
    return {
        "w_x": normal((d, w), d**-0.5),
        "w_gate": normal((d, w), d**-0.5),
        "conv_w": normal((cw, w), cw**-0.5),
        "conv_b": torch.zeros((w,), device=device),
        "w_r": normal((w, w), w**-0.5),
        "b_r": torch.zeros((w,), device=device),
        "w_i": normal((w, w), w**-0.5),
        "b_i": torch.zeros((w,), device=device),
        # Λ parametrized so a ~ U(0.9, 0.999)-ish at init
        "lam": torch.log(torch.expm1(lam)),
        "w_out": normal((w, d), w**-0.5),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear branch above a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rglru_coeffs(params, x: torch.Tensor):
    """Gate computation shared by scan and step. x: (..., w) -> (a, b) f32."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ params["w_r"] + params["b_r"])
    i = torch.sigmoid(xf @ params["w_i"] + params["b_i"])
    log_a = -_A_SCALE * _softplus(params["lam"]) * r  # (..., w), <= 0
    a = torch.exp(log_a)
    gated_x = i * xf
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * gated_x


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): the affine maps h -> a h + b composed."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (even may be one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], dim=1)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of :func:`_combine` over dim 1, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the half, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(params, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Parallel evaluation over (B, S, w); returns (y in x's dtype, h_last f32)."""
    a, b = _rglru_coeffs(params, x)  # (B, S, w) each
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.to(b.dtype)[:, None], b[:, 1:]], dim=1)
    _, h = _assoc_scan(a, b)
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(params, x_t: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """Decode step: x_t (B, w), h_prev (B, w) -> h_t (B, w) in f32."""
    a, b = _rglru_coeffs(params, x_t)
    return a * h_prev.to(torch.float32) + b


def conv1d_causal(params, x: torch.Tensor, tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal temporal conv. x (B, S, w); tail (B, cw - 1, w) history.

    The shifted products are summed in x's dtype in the reference's order,
    term 0 first, then the bias added (not ``F.conv1d``, which accumulates
    in f32 and so rounds otherwise in bf16).
    """
    cw = params["conv_w"].shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    w = params["conv_w"].to(x.dtype)
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out + params["conv_b"].to(x.dtype)


def rglru_block(cfg: ModelConfig, params, x: torch.Tensor, state: Optional[dict]):
    """Full Griffin recurrent block.

    ``state`` None runs the whole sequence (train / prefill) and returns the
    final state; a state ``{"h", "conv"}`` runs one decode token. As in the
    reference, a prefill's ``conv`` keeps the last ``cw - 1`` rows of the
    conv input, fewer when the prompt is shorter (decode then fails as the
    reference's does; ROADMAP Queue C). Returns (y (B, S, D), new_state).
    """
    dt = x.dtype
    main = x @ params["w_x"].to(dt)
    gate = ACTS["gelu"](x @ params["w_gate"].to(dt))
    if state is None:
        conv_out = conv1d_causal(params, main)
        h, h_last = rglru_scan(params, conv_out)
        new_state = {"h": h_last.to(torch.float32),
                     "conv": main[:, -(cfg.rglru_conv_width - 1):, :]}
    else:
        conv_out = conv1d_causal(params, main, tail=state["conv"])
        h_t = rglru_step(params, conv_out[:, 0, :], state["h"])
        h = h_t[:, None, :].to(dt)
        new_state = {"h": h_t, "conv": torch.cat([state["conv"][:, 1:, :], main], dim=1)}
    y = (h.to(dt) * gate) @ params["w_out"].to(dt)
    return y, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, w), dtype=dtype, device=device),
    }
