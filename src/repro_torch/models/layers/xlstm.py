"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``src/repro/models/layers/xlstm.py`` (arXiv:2405.04517).

* mLSTM runs its parallel (quadratic, decay-masked) form over the whole
  sequence for training and prefill, or the chunkwise-recurrent form when
  ``cfg.mlstm_chunk`` divides the sequence, and its O(1) recurrent form
  for decode (state C ∈ R^{h×d×d}), with the running-max stabilizer of the
  paper. With ``cfg.attn_block_q > 0`` dividing the sequence, the parallel
  form runs in blocks of that many query rows, each under
  ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so its
  (B, S, S, H) decay and score tensors shrink to (B, bq, S, H); the numerics
  are the whole form's. The per-head RMS norm of the cell output is
  ``norms.rms_head_norm`` (the reference's ``_head_rmsnorm``).
* sLSTM has recurrent connections (block-diagonal R per head), so it runs
  a Python loop over the time steps (a decode step is the loop's one
  step from the given state); the four gates' input projections are one
  product for all steps before the loop, and their recurrent products one
  batched product a step. On meta tensors :func:`counted_loop_steps` lets
  the dry-run run only the loop's first steps (a step's work does not
  depend on t; ``launch/dryrun.py`` extrapolates).
* The causal-conv front of the official blocks is omitted, as in the
  reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.norms import rms_head_norm

_GATES = ("z", "i", "f", "o")
#: sLSTM time steps a loop over meta tensors runs (None: all of them)
_meta_loop_steps = [None]


def _normal(gen, device):
    return lambda shape, scale: torch.randn(shape, generator=gen, device=device) * scale


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    d_in = int(cfg.d_model * cfg.mlstm_proj_factor)
    return d_in, d_in // cfg.n_heads


def init_mlstm_block(cfg: ModelConfig, gen: Optional[torch.Generator], device) -> dict:
    """The reference's leaves and scales, drawn from ``gen``."""
    d = cfg.d_model
    d_in, hd = _mlstm_dims(cfg)
    h = cfg.n_heads
    s, si = d**-0.5, d_in**-0.5
    normal = _normal(gen, device)
    return {
        "w_up": normal((d, d_in), s),
        "w_gate": normal((d, d_in), s),
        "wq": normal((d_in, d_in), si),
        "wk": normal((d_in, d_in), si),
        "wv": normal((d_in, d_in), si),
        "w_i": normal((d_in, h), si),
        "b_i": torch.zeros((h,), device=device),
        "w_f": normal((d_in, h), si),
        "b_f": torch.full((h,), 3.0, device=device),  # forget-gate bias init
        "out_norm": torch.ones((hd,), device=device),
        "w_down": normal((d_in, d), si),
    }


def _mlstm_qkv_gates(cfg: ModelConfig, params, z: torch.Tensor):
    """z: (B, S, d_in) -> q, k, v (B, S, H, hd); i, f pre-activations (B, S, H) f32."""
    b, s, d_in = z.shape
    h = cfg.n_heads
    hd = d_in // h
    dt = z.dtype
    q = (z @ params["wq"].to(dt)).reshape(b, s, h, hd)
    k = (z @ params["wk"].to(dt)).reshape(b, s, h, hd)
    v = (z @ params["wv"].to(dt)).reshape(b, s, h, hd)
    zf = z.to(torch.float32)
    i_pre = zf @ params["w_i"] + params["b_i"]
    f_pre = zf @ params["w_f"] + params["b_f"]
    return q, k, v, i_pre, f_pre


def mlstm_parallel(cfg: ModelConfig, params, z: torch.Tensor):
    """Stabilized parallel (quadratic) mLSTM over the full sequence.

    Returns (output (B, S, d_in), final recurrent state): the state equals
    what the step recurrence gives after S steps (same stabilizer), so
    prefill seeds decode. ``cfg.attn_block_q`` row blocks: see the module
    docstring.
    """
    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(cfg, params, z)
    b, s, h, hd = q.shape
    log_f = F.logsigmoid(f_pre)  # (B, S, H)
    Fc = torch.cumsum(log_f, dim=1)  # cumulative log forget
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)

    def rows(q_blk, F_blk, off: int):
        """Rows off … off + bq of the stabilized decay-weighted attention."""
        bq = q_blk.shape[1]
        # D̃[t, τ] = F_t - F_τ + ĩ_τ for τ <= t
        Dt = F_blk[:, :, None, :] - Fc[:, None, :, :] + i_pre[:, None, :, :]  # (B, bq, S, H)
        pos = torch.arange(s, device=z.device)
        causal = pos[None, :] <= off + pos[:bq, None]
        Dt = torch.where(causal[None, :, :, None], Dt, float("-inf"))
        m = Dt.amax(dim=2)  # (B, bq, H)
        D = torch.exp(Dt - m[:, :, None, :])
        scores = torch.einsum("bshd,bthd->bsth", q_blk.to(torch.float32), kf)
        scores = scores * (hd**-0.5) * D
        norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))
        return torch.einsum("bsth,bthd->bshd", scores / norm[:, :, None, :], vf)

    bq = cfg.attn_block_q
    if bq and s > bq and s % bq == 0:
        out = torch.cat([checkpoint(rows, q[:, i : i + bq], Fc[:, i : i + bq], i,
                                    use_reentrant=False) for i in range(0, s, bq)], dim=1)
    else:
        out = rows(q, Fc, 0)
    out = rms_head_norm(params["out_norm"], out.to(z.dtype), cfg.norm_eps)

    # final state: w_τ = F_S - F_τ + ĩ_τ, m_S = max_τ w_τ (the step
    # recurrence's m_t = max(log f_t + m_{t-1}, ĩ_t) by induction)
    w = Fc[:, -1:, :] - Fc + i_pre  # (B, S, H)
    m_last = w.amax(dim=1)  # (B, H)
    e = torch.exp(w - m_last[:, None, :])
    k_sc = kf * (hd**-0.5)
    C = torch.einsum("bth,bthd,bthk->bhdk", e, vf, k_sc)
    n = torch.einsum("bth,bthd->bhd", e, k_sc)
    return out.reshape(b, s, h * hd), {"C": C, "n": n, "m": m_last}


def mlstm_chunkwise(cfg: ModelConfig, params, z: torch.Tensor, chunk: int):
    """Chunkwise-recurrent mLSTM: parallel within chunks, O(1) recurrent
    state between them (the same stabilized arithmetic as the parallel form).
    A Python loop over the chunks, as the reference's static loop."""
    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(cfg, params, z)
    b, s, h, hd = q.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    log_f = F.logsigmoid(f_pre)  # (B, S, H)
    qf, kf, vf = (u.to(torch.float32) for u in (q, k, v))
    k_sc = kf * (hd**-0.5)

    C = z.new_zeros((b, h, hd, hd), dtype=torch.float32)
    n = z.new_zeros((b, h, hd), dtype=torch.float32)
    m_run = z.new_full((b, h), -1e30, dtype=torch.float32)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=z.device).tril()
    outs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        lf, ip = log_f[:, sl], i_pre[:, sl]  # (B, L, H)
        Fc = torch.cumsum(lf, dim=1)  # local cumulative log-forget
        # intra-chunk decay D̃[t, τ] = F_t - F_τ + ĩ_τ (τ <= t)
        Dt = Fc[:, :, None, :] - Fc[:, None, :, :] + ip[:, None, :, :]  # (B, L, L, H)
        Dt = torch.where(causal[None, :, :, None], Dt, float("-inf"))
        # inter-chunk decay: the state enters token t with weight F_t + m_run
        w_in = Fc + m_run[:, None, :]  # (B, L, H)
        m_t = torch.maximum(Dt.amax(dim=2), w_in)
        D = torch.exp(Dt - m_t[:, :, None, :])
        e_in = torch.exp(w_in - m_t)

        qc, kc, vc = qf[:, sl], k_sc[:, sl], vf[:, sl]
        scores = torch.einsum("bshd,bthd->bsth", qc, kc) * D  # (B, L, L, H)
        num = torch.einsum("bsth,bthd->bshd", scores, vc)
        num = num + e_in[..., None] * torch.einsum("bhdk,bshk->bshd", C, qc)
        den = scores.sum(dim=2) + e_in * torch.einsum("bhk,bshk->bsh", n, qc)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append((num / den[..., None]).to(z.dtype))

        # the state across the chunk (same stabilizer algebra)
        F_L = Fc[:, -1, :]  # (B, H) the chunk's total log-forget
        w_tau = F_L[:, None, :] - Fc + ip  # (B, L, H): decay from τ to the chunk's end
        m_new = torch.maximum(F_L + m_run, w_tau.amax(dim=1))
        e_tau = torch.exp(w_tau - m_new[:, None, :])
        carry = torch.exp(F_L + m_run - m_new)  # (B, H)
        C = carry[..., None, None] * C + torch.einsum("bth,bthd,bthk->bhdk", e_tau, vc, kc)
        n = carry[..., None] * n + torch.einsum("bth,bthd->bhd", e_tau, kc)
        m_run = m_new

    out = rms_head_norm(params["out_norm"], torch.cat(outs, dim=1), cfg.norm_eps)
    return out.reshape(b, s, h * hd), {"C": C, "n": n, "m": m_run}


def mlstm_step(cfg: ModelConfig, params, z_t: torch.Tensor, state: dict):
    """Recurrent decode step. z_t (B, 1, d_in); state {C, n, m}."""
    q, k, v, i_pre, f_pre = _mlstm_qkv_gates(cfg, params, z_t)
    b, _, h, hd = q.shape
    q, k, v = (u[:, 0].to(torch.float32) for u in (q, k, v))  # (B, H, hd)
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]  # (B, H)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    f_sc = torch.exp(log_f + state["m"] - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    k_sc = k * (hd**-0.5)
    C = f_sc[..., None] * state["C"] + i_sc[..., None] * (v[..., :, None] * k_sc[..., None, :])
    n = f_sc * state["n"] + i_sc * k_sc
    num = torch.einsum("bhdk,bhk->bhd", C, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(), torch.exp(-m_new))
    out = (num / den[..., None]).to(z_t.dtype)  # (B, H, hd)
    out = rms_head_norm(params["out_norm"], out, cfg.norm_eps)
    return out.reshape(b, 1, h * hd), {"C": C, "n": n, "m": m_new}


def mlstm_block(cfg: ModelConfig, params, x: torch.Tensor, state: Optional[dict]):
    """Returns (y (B, S, D), new_state); ``state`` None runs the whole sequence."""
    dt = x.dtype
    z = x @ params["w_up"].to(dt)
    gate = F.silu(x @ params["w_gate"].to(dt))
    if state is None:
        chunk = cfg.mlstm_chunk
        if chunk and x.shape[1] > chunk and x.shape[1] % chunk == 0:
            cell, new_state = mlstm_chunkwise(cfg, params, z, chunk)
        else:
            cell, new_state = mlstm_parallel(cfg, params, z)
    else:
        cell, new_state = mlstm_step(cfg, params, z, state)
    y = (cell * gate) @ params["w_down"].to(dt)
    return y, new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    _, hd = _mlstm_dims(cfg)
    h = cfg.n_heads
    return {
        "C": torch.zeros((batch, h, hd, hd), device=device),
        "n": torch.zeros((batch, h, hd), device=device),
        "m": torch.full((batch, h), -1e30, device=device),
    }


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def _slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    h = cfg.n_heads
    d_in = int(cfg.d_model * cfg.slstm_proj_factor)
    d_in = (d_in // h) * h  # divisible by heads
    return d_in, d_in // h


def init_slstm_block(cfg: ModelConfig, gen: Optional[torch.Generator], device) -> dict:
    """The reference's leaves and scales, drawn from ``gen``."""
    d = cfg.d_model
    d_in, hd = _slstm_dims(cfg)
    h = cfg.n_heads
    normal = _normal(gen, device)
    p = {
        "w_up": normal((d, d_in), d**-0.5),
        "w_down": normal((d_in, d), d_in**-0.5),
        "out_norm": torch.ones((d_in,), device=device),
    }
    for name in _GATES:
        p[f"w_{name}"] = normal((d_in, d_in), d_in**-0.5)
        # block-diagonal recurrent connections, one dense matrix per head
        p[f"r_{name}"] = normal((h, hd, hd), hd**-0.5)
        p[f"b_{name}"] = torch.full((d_in,), 3.0 if name == "f" else 0.0, device=device)
    return p


def _r_all(params) -> torch.Tensor:
    """The four gates' recurrent matrices side by side: (H, hd, 4·hd)."""
    return torch.cat([params[f"r_{g}"] for g in _GATES], dim=-1)


def _slstm_step(pre_x: torch.Tensor, st: tuple, r_all: torch.Tensor):
    """One time step on head-major operands. ``pre_x`` (H, B, 4, hd): the
    input projections of z, i, f, o; ``st`` (c, n, m, h), each (H, B, hd)
    f32. Returns the new (c, n, m, h)."""
    c, n, m, h = st
    nh, b, _, hd = pre_x.shape
    # block-diagonal recurrent contribution per head, the four gates at once
    pre = pre_x + torch.bmm(h, r_all).view(nh, b, 4, hd)
    z = torch.tanh(pre[:, :, 0])
    i_pre = pre[:, :, 1]
    log_f = F.logsigmoid(pre[:, :, 2])
    o = torch.sigmoid(pre[:, :, 3])
    log_f_m = log_f + m
    m_new = torch.maximum(log_f_m, i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f_m - m_new)
    c = f_sc * c + i_sc * z
    n = f_sc * n + i_sc
    return c, n, m_new, o * c / torch.clamp(n, min=1e-6)


class counted_loop_steps:
    """Within it an sLSTM loop over meta tensors runs its first ``n``
    steps; the later steps' outputs are detached copies of the last that
    ran, with no work and no gradient. Only the dry-run's counts use it:
    a loop's work is linear in the steps it runs."""

    def __init__(self, n: int):
        self.n = int(n)

    def __enter__(self):
        self._prev, _meta_loop_steps[0] = _meta_loop_steps[0], self.n
        return self

    def __exit__(self, *exc):
        _meta_loop_steps[0] = self._prev


def _slstm_cell(params, x_proj: dict, state: dict, h_heads: int):
    """One time step, as the reference's: ``x_proj`` holds the input
    projections ``x_t @ W_* + b_*`` of z, i, f, o; ``state`` {c, n, m, h},
    each (B, d_in) f32 with d_in head-major."""
    b, d_in = x_proj["z"].shape
    hd = d_in // h_heads
    pre_x = torch.stack([x_proj[g].reshape(b, h_heads, hd) for g in _GATES], dim=2).transpose(0, 1)
    st = tuple(state[k].reshape(b, h_heads, hd).transpose(0, 1) for k in "cnmh")
    new = _slstm_step(pre_x, st, _r_all(params))
    return {k: u.transpose(0, 1).reshape(b, d_in) for k, u in zip("cnmh", new)}


def slstm_block(cfg: ModelConfig, params, x: torch.Tensor, state: Optional[dict]):
    """x (B, S, D). ``state`` None: the loop over time from the zero state;
    else one decode step from ``state``. Returns (y, new_state).

    The input projections of all steps are one product before the loop,
    viewed (S, H, B, 4, hd) so that a step adds its recurrent term with one
    addition; inside the loop the state is head-major, (H, B, hd), the
    batch of the recurrent product.
    """
    dt = x.dtype
    b, s, _ = x.shape
    d_in, hd = _slstm_dims(cfg)
    h = cfg.n_heads
    z_in = (x @ params["w_up"].to(dt)).to(torch.float32)
    w_all = torch.cat([params[f"w_{g}"] for g in _GATES], dim=1)
    b_all = torch.cat([params[f"b_{g}"] for g in _GATES])
    pre_x = (z_in @ w_all + b_all).view(b, s, 4, h, hd).permute(1, 3, 0, 2, 4)  # (S, H, B, 4, hd)
    r_all = _r_all(params)
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    st = tuple(state[k].reshape(b, h, hd).transpose(0, 1) for k in "cnmh")
    hs = []
    n = s if _meta_loop_steps[0] is None or x.device.type != "meta" else min(s, _meta_loop_steps[0])
    for t in range(n):
        st = _slstm_step(pre_x[t], st, r_all)
        hs.append(st[3])
    hs += [hs[-1].detach() for _ in range(s - n)]
    out = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d_in)  # (S, H, B, hd) -> (B, S, d_in)
    new_state = {k: u.transpose(0, 1).reshape(b, d_in) for k, u in zip("cnmh", st)}
    out = _head_rmsnorm_flat(params["out_norm"], out, hd, cfg.norm_eps)
    y = out.to(dt) @ params["w_down"].to(dt)
    return y, new_state


def _head_rmsnorm_flat(scale: torch.Tensor, x: torch.Tensor, hd: int, eps: float) -> torch.Tensor:
    """Group-norm over heads for flat (..., d_in) activations."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], shape[-1] // hd, hd).to(torch.float32)
    var = xh.square().mean(dim=-1, keepdim=True)
    xh = xh / torch.sqrt(var + eps)
    return (xh.reshape(shape) * scale).to(x.dtype)


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> dict:
    d_in, _ = _slstm_dims(cfg)
    return {
        "c": torch.zeros((batch, d_in), device=device),
        "n": torch.zeros((batch, d_in), device=device),
        "m": torch.full((batch, d_in), -1e30, device=device),
        "h": torch.zeros((batch, d_in), device=device),
    }
