"""The port's query-row blocks (``cfg.attn_block_q``) in ``attention_full``
and ``mlstm_parallel`` against the JAX package's blockwise path.

Five reduced configs (``tests/_torch_recurrent.py``: the reference's random
parameters, every bias and norm scale moved off its init value, carried
across with ``params_from_numpy``): qwen2-1.5b and llama3.2-3b (causal
attention, as ``tests/test_perf_variants.py`` runs them), xlstm-125m (the
mLSTM's parallel form), recurrentgemma-9b (the windowed ``local`` mixer;
its reduced window of 16 binds at 24 tokens) and whisper-small (the
bidirectional encoder over its 16 frames, and the causal decoder). Blocks of
8 rows over 24 tokens: three blocks a layer.

Tolerances: the blocked forward against the reference's blocked forward and
against the port's whole form, hidden states to atol 5e-5 (the reference's
own blocked-vs-whole limit); the loss blocked against whole to 1e-5
relative, and every gradient entry to 1e-5 of the gradient's largest entry
over all leaves (the same products summed over the blocks' rows in another
order: a leaf whose terms cancel, as the mLSTM's input-gate bias, differs by
more than 1e-5 of its own scale).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_recurrent import configs, extras, port_params, ref_params, tokens, torch_extras

from repro.models import model as ref_model
from repro_torch.models import model as mdl
from repro_torch.models.layers import attention, xlstm
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

ARCHS = ["qwen2-1.5b", "llama3.2-3b", "xlstm-125m", "recurrentgemma-9b", "whisper-small"]
BQ = 8
S = 24  # three blocks of BQ
HIDDEN_ATOL = 5e-5
GRAD_RTOL = 1e-5


def _port(arch, bq):
    cfg, params = port_params(arch)
    return dataclasses.replace(cfg, attn_block_q=bq), params


def _port_hidden(arch, bq):
    cfg, params = _port(arch, bq)
    toks, _ = tokens(cfg.vocab_size, s=S)
    with torch.no_grad():
        hidden, _, _ = mdl.forward(cfg, params, torch.from_numpy(toks), **torch_extras(cfg, 2))
    return hidden.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_blocked_forward_matches_reference(arch):
    ref_cfg, cfg = configs(arch, attn_block_q=BQ)
    toks, _ = tokens(cfg.vocab_size, s=S)
    fwd = jax.jit(lambda p, t, ex: ref_model.forward(ref_cfg, p, t, **ex)[0])
    want = np.asarray(fwd(ref_params(arch), toks, extras(ref_cfg, 2)), np.float32)
    got = _port_hidden(arch, BQ)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=HIDDEN_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_blocked_forward_equals_whole(arch):
    np.testing.assert_allclose(_port_hidden(arch, BQ), _port_hidden(arch, 0), atol=HIDDEN_ATOL,
                               rtol=0)


def _grads(arch, bq):
    cfg, params = _port(arch, bq)
    params.requires_grad_(True)
    toks, tgts = tokens(cfg.vocab_size, s=S)
    loss, _ = mdl.loss_fn(cfg, params, torch.from_numpy(toks), torch.from_numpy(tgts),
                          **torch_extras(cfg, toks.shape[0]))
    names, leaves = zip(*params.named_parameters())
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_blocked_equal_whole(arch):
    loss_b, blocked = _grads(arch, BQ)
    loss_w, whole = _grads(arch, 0)
    assert abs(loss_b - loss_w) <= GRAD_RTOL * abs(loss_w)
    assert list(blocked) == list(whole)
    scale = max(float(w.abs().max()) for w in whole.values())
    for name, w in whole.items():
        g = blocked[name]
        assert torch.isfinite(g).all(), name
        assert float((g - w).abs().max()) <= GRAD_RTOL * scale, name


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "xlstm-125m", "whisper-small"])
def test_each_block_runs_under_checkpoint(arch, monkeypatch):
    """A spy on the layers' ``checkpoint``: every block of every blocked layer
    (three over the tokens, two over the whisper encoder's 16 frames) runs
    under it with ``use_reentrant=False``; the whole form never does."""
    calls = []

    def spy(fn, *args, **kw):
        calls.append(args[0].shape[1])
        assert kw == {"use_reentrant": False}
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(attention, "checkpoint", spy)
    monkeypatch.setattr(xlstm, "checkpoint", spy)
    cfg, _ = _port(arch, BQ)
    layers = sum(mixer in ("attn", "local", "mlstm") for mixer, _ in cfg.all_blocks)
    enc, frames = (cfg.encoder.n_layers, cfg.encoder.n_frames) if cfg.encoder else (0, 0)
    _port_hidden(arch, BQ)
    assert calls == [BQ] * (enc * frames // BQ + layers * S // BQ)
    calls.clear()
    _port_hidden(arch, 0)
    assert calls == []
