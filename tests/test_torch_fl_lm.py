"""The port's federated LM driver against the JAX package's.

``flatten_lm`` of an LM against the reference's ``flatten_params`` of its
stacked tree, one ``fl_round_step`` on the same parameters and tokens, a
client drawn twice, what the mesh tooling still refuses, the sampler specs and the
example. The whole ``run_federated_lm`` runs, one file per family, are in
``test_torch_fl_lm_dense.py`` (the f32 reduced qwen3-0.6b at
``examples/federated_lm.py``'s widths under each sampler),
``test_torch_fl_lm_moe.py`` (reduced deepseek-v2-lite and qwen2-moe),
``test_torch_fl_lm_recurrent.py`` (reduced xlstm-125m) and
``test_torch_fl_lm_vl.py`` (reduced qwen2-vl-2b), sharing
``tests/_torch_fl_lm.py``.

Tolerances: flat vectors bit for bit; a round step's parameters and
updates to atol 2e-6 on entries up to 0.05 (measured ≤ 1.2e-7: the GEMMs
sum in other orders) and its loss to 2e-6 (measured 1.4e-6, three ulps at
6).
"""
import contextlib
import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fl_lm import FL, SIZES, STEP_ATOL, configs, ref_params
from repro.core import ClientPopulation as RefPopulation
from repro.fl.aggregation import flatten_params as ref_flatten
from repro.launch import fl_train as ref_fl
from repro_torch.core import ClientPopulation
from repro_torch.launch import fl_train
from repro_torch.models import model as mdl
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()


# --------------------------------------------------------------------------
# flat vectors
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,n_layers", [("qwen3-0.6b", None), ("qwen3-0.6b", 3),
                                           ("qwen2-1.5b", 2), ("llama3.2-3b", 2),
                                           ("qwen2-moe-a2.7b", 2), ("deepseek-v2-lite-16b", None),
                                           ("xlstm-125m", None), ("xlstm-125m", 4),
                                           ("recurrentgemma-9b", None)])
def test_flatten_params_of_an_lm_is_bit_equal_to_the_reference(arch, n_layers):
    """qk-norm; a stack of 3 layers; QKV biases; llama's head (tied or not
    as its config says); the MoE's stacked experts and nested shared MLP;
    MLA's nested kv_norm beside a dense first block (the narrow reduced
    MoE configs of the federated runs below); xLSTM's ``rec`` leaves with
    no FFN, in one period and in two; recurrentgemma's RG-LRU and local
    blocks with its two tail blocks."""
    overrides = {} if n_layers is None else {"n_layers": n_layers}
    _, cfg = configs(arch, **overrides)
    tree = ref_params(arch, n_layers)
    lm = mdl.params_from_numpy(cfg, tree, device="cpu")
    want = np.asarray(ref_flatten(tree))
    got = mdl.flatten_lm(lm)
    assert got.dtype == torch.float32 and got.numel() == want.size == mdl.param_count(lm)
    np.testing.assert_array_equal(got.numpy(), want)


def test_unflatten_params_gives_views_that_flatten_back():
    _, cfg = configs(n_layers=3)
    lm = mdl.params_from_numpy(cfg, ref_params(n_layers=3), device="cpu")
    flat = mdl.flatten_lm(lm).clone()
    views = mdl.lm_views(flat, lm)
    assert views.layout == lm.layout
    assert torch.equal(mdl.flatten_lm(views), flat)
    for (n, a), (m, b) in zip(views.named_parameters(), lm.named_parameters()):
        assert n == m and torch.equal(a, b)
        assert a.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    with torch.no_grad():
        views.blocks[1]["attn"]["wq"].add_(1.0)
    assert not torch.equal(flat, mdl.flatten_lm(lm))


def test_lm_views_and_a_round_step_leave_no_reference_cycle(monkeypatch):
    """With the garbage collector off, dropping an LM of views frees its
    flat vector at once, and dropping a round step's outputs frees its
    (m, d) client stack: a reference cycle in ``lm_views`` (a recursive
    closure over the views) had kept each round's stack alive until the
    collector ran, so a full-width round could find the last round's 32 GiB
    stack still allocated."""
    _, cfg = configs()
    lm = mdl.params_from_numpy(cfg, ref_params(), device="cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2, 2, 16))).long()
    stacks, real = [], torch.Tensor.new_empty

    def new_empty(self, *a, **kw):
        out = real(self, *a, **kw)
        stacks.append(weakref.ref(out))
        return out

    gc.collect()
    gc.disable()
    try:
        flat = mdl.flatten_lm(lm)
        alive = weakref.ref(flat)
        views = mdl.lm_views(flat, lm)
        del flat, views
        assert alive() is None
        monkeypatch.setattr(torch.Tensor, "new_empty", new_empty)
        step = fl_train.make_fl_round_step(cfg, 0.1, 2, with_updates=True)
        out = step(lm, toks, (toks + 31) % cfg.vocab_size, torch.full((3,), 1 / 3))
        assert any(r() is not None and tuple(r().shape) == (3, mdl.param_count(lm)) for r in stacks)
        del out
        assert all(r() is None for r in stacks)
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# one round step
# --------------------------------------------------------------------------
def test_fl_round_step_matches_the_reference():
    ref_cfg, cfg = configs()
    tree = ref_params()
    rng = np.random.default_rng(6)
    m, n, b, s = 3, 2, 2, 16
    toks = rng.integers(0, cfg.vocab_size, (m, n, b, s)).astype(np.int32)
    tgts = (toks + 31) % cfg.vocab_size
    w = np.array([0.5, 0.3, 0.2], np.float32)
    ref_step = jax.jit(ref_fl.make_fl_round_step(ref_cfg, 0.1, n, with_updates=True))
    want_params, want_loss, want_updates = ref_step(
        jax.tree_util.tree_map(jnp.asarray, tree), toks, tgts, w)
    step = fl_train.make_fl_round_step(cfg, 0.1, n, with_updates=True)
    lm = mdl.params_from_numpy(cfg, tree, device="cpu")
    new, loss, updates = step(lm, *(torch.from_numpy(a).long() for a in (toks, tgts)),
                              torch.from_numpy(w))
    np.testing.assert_allclose(float(loss), float(want_loss), atol=2e-6, rtol=0)
    np.testing.assert_allclose(updates.numpy(), np.asarray(want_updates), atol=STEP_ATOL)
    got = mdl.params_to_numpy(cfg, new)
    for a, b_ in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, np.asarray(b_), atol=STEP_ATOL)
    # the input model is untouched, as the reference's arrays are
    assert torch.equal(mdl.flatten_lm(lm), torch.from_numpy(np.array(ref_flatten(tree))))


def test_a_client_drawn_twice_keeps_its_first_draws_update(monkeypatch):
    """Both drivers observe np.unique's first slot of a repeated client."""
    cfg_ref, cfg = configs()
    tree = ref_params()
    monkeypatch.setattr(mdl, "init_params", lambda c, seed=0, *, device="cuda":
                        mdl.params_from_numpy(c, tree, device=device))
    fixed = np.array([5, 2, 5, 9])
    got = {}
    for who, pkg, pop, kw in (("ref", ref_fl, RefPopulation(SIZES), {}),
                              ("port", fl_train, ClientPopulation(SIZES), {"device": "cpu"})):
        fl = pkg.FLLMConfig(**{**FL, "n_rounds": 1}, sampler="algorithm2")
        d = int(ref_flatten(tree).shape[0])
        with contextlib.closing(pkg.make_lm_sampler(fl, pop, update_dim=d, **kw)) as sm:
            sm.sample = lambda t, *a, **k: types.SimpleNamespace(clients=fixed)
            seen = []
            real = sm.observe_updates
            sm.observe_updates = lambda ids, u: seen.append((np.asarray(ids), np.asarray(u))) or real(ids, u)
            run_cfg = cfg_ref if who == "ref" else cfg
            pkg.run_federated_lm(run_cfg, fl, sm, **kw)
            got[who] = seen[0]
    np.testing.assert_array_equal(got["port"][0], [2, 5, 9])
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    np.testing.assert_allclose(got["port"][1], got["ref"][1], atol=STEP_ATOL)


def test_mesh_tooling_raises_naming_a13():
    """Nothing of the mesh tooling raises any more: the production mesh
    (A13.3) is meta positions, on which the dry-run counts the port's steps
    (tests/test_torch_dryrun.py). The round's placements (``fl_input_specs``,
    ``fl_round_shardings``, ``mesh=``) and the train step's (A13.2) are
    ported (tests/test_torch_fl_sharded.py, tests/test_torch_sharding.py)."""
    from repro_torch.launch import mesh

    for kw, shape in (({}, (16, 16)), ({"multi_pod": True}, (2, 16, 16))):
        pod = mesh.make_production_mesh(**kw)
        assert pod.devices.shape == shape
        assert all(d.type == "meta" for d in pod.devices.flat)
        assert len({pod.device_key(p) for p in range(pod.devices.size)}) == pod.devices.size


def test_sampler_spec_and_planner_spec_resolve_as_the_reference():
    for sampler, planner in (("md", "sync"), ({"name": "algorithm2", "options": {"measure": "l1"}},
                                              {"mode": "async", "rebuild_every": 2})):
        ref = ref_fl.FLLMConfig(m=5, seed=3, sampler=sampler, planner=planner)
        port = fl_train.FLLMConfig(m=5, seed=3, sampler=sampler, planner=planner)
        assert port.sampler_spec().to_dict() == ref.sampler_spec().to_dict()
        assert port.planner_spec().to_dict() == ref.planner_spec().to_dict()
    with pytest.raises(ValueError, match="contradicts"):
        fl_train.FLLMConfig(m=5, sampler=fl_train.FLLMConfig(m=4).sampler_spec()).sampler_spec()


# --------------------------------------------------------------------------
# the example
# --------------------------------------------------------------------------
def _example():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_federated_lm.py"
    spec = importlib.util.spec_from_file_location("torch_federated_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sampler", ["md", "algorithm2"])
def test_example_runs_on_the_cpu(sampler, capsys):
    _example().main(["--device", "cpu", "--sampler", sampler, "--rounds", "3"])
    out = capsys.readouterr().out
    assert f"federated LM (qwen3-0.6b-reduced, {sampler}" in out and "on cpu" in out
    assert out.count("mean local loss") == 3 and "improved: True" in out


def test_example_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example().main(["--rounds", "1"])
