"""The port's placement rules, abstract specs, FL engine hooks and sharded
train step against the JAX reference's.

In this process (one CPU device): ``param_spec`` leaf by leaf for the 10
reduced configs, ``input_specs`` / ``abstract_params`` /
``abstract_train_state`` against ``jax.eval_shape``, and the FL engine's
step against the reference's with ``tests/test_round_engine.py``'s
settings. In one subprocess with four fake CPU devices and the reference's
``make_host_mesh(2, 2)`` (Auto axes): ``build_shardings``' specs for every
config at full width (parameters, moments, batch, decode caches), the specs
``constrain`` hands to ``with_sharding_constraint``, the per-position
parameter counts of qwen3-0.6b, and the reference's own sharded train
step, ``jax.jit(step, in_shardings=…, out_shardings=…)`` under
``sharding_hints``, for reduced qwen3 and deepseek-v2-lite (f32, d_model 64,
vocab 256, 3 steps of the reference's default AdamW), deepseek once at a
batch whose data blocks hold whole 64-token groups (4 × 32) and once at
one whose blocks would split its only group (4 × 16).

The port's step runs over ``make_host_mesh(2, 2, device="cpu")``. Block
slices are held equal at every mesh position; losses to 1e-5 and gradient
norms to 1e-5 relative (the trainers' ``STEP_TOL``); parameters and Adam's
moments after every step to atol 3e-5, except where some step's gradient
entry in the oracle run is nonzero and below 10·ε, there to the learning
rate (AdamW turns last-bit gradient differences into a whole step: the
trainers' limit, ``tests/test_torch_moe_train.py``). The port's sharded
step is held to its own one-card step by the same limits.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config as ref_get_config
from repro.launch import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.models import simple as ref_simple
from repro.models.config import INPUT_SHAPES as REF_SHAPES
from repro.optim import sgd as ref_sgd
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, sharding, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as mdl
from repro_torch.models import sharding_hints as hints
from repro_torch.models import simple
from repro_torch.models.config import INPUT_SHAPES, InputShape
from repro_torch.optim.sgd import sgd
from repro_torch.testing import pin_cpu_threads, thread_env

pin_cpu_threads()

ROOT = os.path.join(os.path.dirname(__file__), "..")
NARROW = dict(d_model=64, vocab_size=256, scan_layers=False)
RUNS = {"qwen3": ("qwen3-0.6b", 4, 32), "deepseek": ("deepseek-v2-lite-16b", 4, 32),
        "deepseek_split": ("deepseek-v2-lite-16b", 4, 16)}
N_STEPS = 3
STEP_TOL = 1e-5
PARAM_ATOL = 3e-5
TINY_GRAD = 10 * 1e-8  # 10·ε, AdamW's ε
LR = 3e-4  # the reference's default_optimizer
SPEC_SHAPES = {"train": InputShape("t", 32, 4, "train"), "prefill": InputShape("p", 32, 4, "prefill"),
               "decode": InputShape("d", 32, 4, "decode"), "decode_odd": InputShape("o", 33, 3, "decode")}
ENGINE = dict(n_clients=8, m_slots=4, n_pad=20, n_steps=3, batch_size=8)
ENGINE_CASES = {"flat": (16, (16, 32, 10)), "image": ((4, 4, 3), (48, 24, 10))}
COUNT_MESHES = ((2, 2), (4, 1), (1, 4))
STATE_PARTS = ("['params']", "['opt_state']['mu']", "['opt_state']['nu']")

ORACLE = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCH_NAMES, get_config
from repro.launch.dryrun import build_shardings
from repro.launch.mesh import batch_axes, make_host_mesh
from repro.launch.sharding import param_shardings
from repro.launch.steps import (abstract_params, default_optimizer, fl_engine_input_specs,
                                fl_engine_shardings, make_train_step)
from repro.models import model as mdl
from repro.models.config import InputShape
from repro.models.sharding_hints import sharding_hints

SPEC_SHAPES, RUNS, NARROW, N_STEPS, ENGINE, COUNT_MESHES = (
    {k: InputShape(*v) for k, v in json.loads(sys.argv[2]).items()}, *json.loads(sys.argv[3]))
out, arrays = {}, {}
mesh = make_host_mesh(2, 2)
position = {d.id: i for i, d in enumerate(mesh.devices.flat)}


def spec(sh):
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): spec(s) for p, s in flat}


opt = default_optimizer()
out["specs"] = {}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    got = {}
    (state_sh, batch_sh), _, _ = build_shardings(cfg, SPEC_SHAPES["train"], mesh, "train", opt)
    got["params"] = specs(state_sh["params"])
    got["opt_state"] = specs(state_sh["opt_state"])
    got["step"] = specs(state_sh["step"])
    got["batch"] = specs(batch_sh)
    got["expert_parallel"] = specs(param_shardings(mesh, abstract_params(cfg), expert_parallel=True))
    for kind in ("decode", "decode_odd"):
        (_, batch_sh), (logits_sh, _), _ = build_shardings(cfg, SPEC_SHAPES[kind], mesh, "decode", opt)
        got[kind] = specs(batch_sh)
        got[kind + "_logits"] = spec(logits_sh)
    (_, batch_sh), (logits_sh, cache_sh), _ = build_shardings(cfg, SPEC_SHAPES["prefill"], mesh,
                                                             "prefill", opt)
    got["prefill"] = specs(batch_sh)
    got["prefill_caches"] = specs(cache_sh)
    out["specs"][arch] = got

# constrain: the specs it hands to with_sharding_constraint, with its tokens
seen = []


def record(x, s):
    dims = sys._getframe(1).f_locals["dims"]
    seen.append([list(x.shape), list(dims), [list(e) if isinstance(e, tuple) else e for e in s]])
    return x


wsc, jax.lax.with_sharding_constraint = jax.lax.with_sharding_constraint, record
out["constrain"] = {}
for arch in ARCH_NAMES:
    cfg = get_config(arch, reduced=True)
    params = jax.eval_shape(lambda: mdl.init_params(cfg, jax.random.PRNGKey(0)))
    b, s = 4, 32
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    extra = {}
    if cfg.frontend == "vision":
        extra["vision_embeds"] = jax.ShapeDtypeStruct((b, cfg.n_vision_tokens, cfg.d_model), jnp.float32)
    if cfg.frontend == "audio":
        extra["frames"] = jax.ShapeDtypeStruct((b, cfg.encoder.n_frames, cfg.d_model), jnp.float32)
    caches = jax.eval_shape(lambda: mdl.init_cache(cfg, b, s))
    seen.clear()
    with mesh, sharding_hints(batch_axes(mesh)):
        jax.eval_shape(lambda p, t, e: mdl.loss_fn(cfg, p, t, t, **e), params, tok, extra)
        jax.eval_shape(lambda p, t, c: mdl.decode_step(cfg, p, t, c), params,
                       jax.ShapeDtypeStruct((b, 1), jnp.int32), caches)
    out["constrain"][arch] = [list(r) for r in {json.dumps(r): r for r in seen}.values()]
jax.lax.with_sharding_constraint = wsc

# per-position parameter elements at full width
cfg = get_config("qwen3-0.6b")
pshape = abstract_params(cfg)
out["counts"] = {}
for d, m in COUNT_MESHES:
    cmesh = make_host_mesh(d, m)
    sh = param_shardings(cmesh, pshape)
    per, rep = 0, 0
    for leaf, s in zip(jax.tree_util.tree_leaves(pshape), jax.tree_util.tree_leaves(sh)):
        n = int(np.prod(s.shard_shape(leaf.shape)))
        per += n
        rep += n if s.shard_shape(leaf.shape) == leaf.shape else 0
    out["counts"][f"{d}x{m}"] = [per, rep]

# the FL engine's hooks
out["engine"] = {}
for n_clients, m_slots in ((ENGINE["n_clients"], ENGINE["m_slots"]), (7, 3)):
    sp = fl_engine_input_specs(n_clients, m_slots, ENGINE["n_pad"], (4, 4, 3), ENGINE["n_steps"],
                               ENGINE["batch_size"])
    out["engine"][f"{n_clients}/{m_slots}"] = {k: spec(v) for k, v in fl_engine_shardings(mesh, sp).items()}

# the sharded train steps
out["runs"] = {}
for run, (arch, b, s) in RUNS.items():
    cfg = dataclasses.replace(get_config(arch, reduced=True), **NARROW)
    in_sh, out_sh, _ = build_shardings(cfg, InputShape("t", s, b, "train"), mesh, "train", opt)
    params = mdl.init_params(cfg, jax.random.PRNGKey(0))
    state = jax.device_put({"params": params, "opt_state": opt.init(params),
                            "step": jnp.zeros((), jnp.int32)}, in_sh[0])
    rng = np.random.default_rng(7)
    metrics = []
    with mesh, sharding_hints(batch_axes(mesh)):
        step = jax.jit(make_train_step(cfg, opt), in_shardings=in_sh, out_shardings=out_sh)
        for i in range(N_STEPS):
            batch = {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
                     for k in ("tokens", "targets")}
            for k, v in batch.items():
                arrays[f"{run}/batch{i}/{k}"] = v
            state, m = step(state, jax.device_put(batch, in_sh[1]))
            metrics.append({k: float(v) for k, v in m.items()})
            for p, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
                arrays[f"{run}/step{i}/{jax.tree_util.keystr(p)}"] = np.asarray(leaf)
    for p, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        idx = np.zeros((mesh.devices.size, leaf.ndim, 2), np.int64)
        for shard in leaf.addressable_shards:
            idx[position[shard.device.id]] = np.reshape(
                [[sl.start or 0, leaf.shape[a] if sl.stop is None else sl.stop]
                 for a, sl in enumerate(shard.index)], (leaf.ndim, 2))
        arrays[f"{run}/index/{jax.tree_util.keystr(p)}"] = idx
    out["runs"][run] = metrics

np.savez(sys.argv[1] + ".npz", **arrays)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(out, f)
"""


# --------------------------------------------------------------------------
# the reference's oracle run, started before the in-process tests
# --------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def _oracle_run(tmp_path_factory):
    """The oracle subprocess, started when the module's first test starts."""
    base = str(tmp_path_factory.mktemp("sharding") / "oracle")
    env = thread_env(dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"),
                          XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    shapes = {k: [v.name, v.seq_len, v.global_batch, v.kind] for k, v in SPEC_SHAPES.items()}
    rest = [RUNS, NARROW, N_STEPS, ENGINE, COUNT_MESHES]
    proc = subprocess.Popen([sys.executable, "-c", ORACLE, base, json.dumps(shapes), json.dumps(rest)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, base
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def oracle(_oracle_run):
    proc, base = _oracle_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(base + ".json") as f:
        out = json.load(f)
    with np.load(base + ".npz") as z:
        out["arrays"] = dict(z)
    return out


# --------------------------------------------------------------------------
# the reference's tree layout of the port's trees
# --------------------------------------------------------------------------
def _entry(e):
    """A spec entry in one form: a 1-tuple of axes is its axis."""
    e = list(e) if isinstance(e, (tuple, list)) else e
    return e[0] if isinstance(e, list) and len(e) == 1 else e


def _spec(spec, stacked=False) -> str:
    return json.dumps(([None] if stacked else []) + [_entry(e) for e in spec])


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_layout(like, value) -> dict:
    """The reference's parameter tree of ``value(stacked, names)`` over the
    port's LM ``like``."""
    tree: dict = {}
    for path, names in mdl.reference_leaves(like):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value("stack" in path[:2], names)
    nf, _, _, nt = like.layout
    for part, n in (("first", nf), ("tail", nt)):
        tree[part] = tuple(tree.get(part, {})[str(i)] for i in range(n))
    return tree


def _ref_cache_layout(cfg, caches, value) -> dict:
    """The reference's cache tree of ``value(stacked, [leaf of each layer])``
    over the port's per-layer caches."""
    nf, period, reps, nt = mdl.stack_layout(cfg)
    layers = caches["layers"]

    def conv(idx, stacked):
        return {k: value(stacked, [layers[i][k] for i in idx]) for k in layers[idx[0]]}

    return {"first": tuple(conv([i], False) for i in range(nf)),
            "stack": {f"pos{j}": conv([nf + r * period + j for r in range(reps)], True)
                      for j in range(period)},
            "tail": tuple(conv([nf + period * reps + i], False) for i in range(nt)),
            "pos": value(False, [caches["pos"]])}


def _one(values):
    assert all(v == values[0] for v in values[1:]), values
    return values[0]


def _placement_spec(stacked, placements) -> str:
    return _one([_spec(p.spec, stacked) for p in placements])


def _desc(shape, dtype) -> str:
    return f"{tuple(int(n) for n in shape)} {np.dtype(dtype).name}"


def _tensor_desc(stacked, tensors) -> str:
    """A port leaf (a tensor, or a cache's int position) as the reference's."""
    t = tensors[0]
    if isinstance(t, int):
        shape, dt = (), "int32"
    else:
        shape, dt = tuple(t.shape), str(t.dtype).replace("torch.", "")
    assert all(_tensor_desc(False, [u]) == _desc(shape, dt) for u in tensors[1:])
    return _desc(((len(tensors),) if stacked else ()) + shape, dt)


def _ref_desc(tree) -> dict:
    return {k: _desc(v.shape, v.dtype) for k, v in _flat(tree).items()}


def _port_params(like, tensors_by_name, stacked_value):
    return _ref_layout(like, lambda st, names: stacked_value(st, [tensors_by_name[n] for n in names]))


def _port_caches_desc(cfg, caches) -> dict:
    return _flat(_ref_cache_layout(cfg, caches, _tensor_desc))


# --------------------------------------------------------------------------
# in this process
# --------------------------------------------------------------------------
def _ref_abstract(cfg):
    return jax.eval_shape(lambda: ref_model.init_params(cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_spec_matches_reference(arch):
    """``param_spec`` is a pure function of the leaf path: equal for every
    leaf of the reduced config, with and without expert parallelism, over
    one batch axis and two."""
    tree = _ref_abstract(ref_get_config(arch, reduced=True))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        pstr = ref_sharding._path_str(path)
        stacked = "/stack/" in f"/{pstr}/" or pstr.startswith("stack/")
        ndim = leaf.ndim - int(stacked)
        for fsdp in (("data",), ("pod", "data")):
            for ep in (False, True):
                want = ref_sharding.param_spec(pstr, ndim, fsdp, expert_parallel=ep)
                got = sharding.param_spec(pstr, ndim, fsdp, expert_parallel=ep)
                assert got == tuple(want), (pstr, got, want)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch):
    """The four assigned shapes at full width: tokens, decode caches and
    front-end stubs, shapes and dtypes; the port's cache positions are
    Python ints (its caches' own form), standing for the reference's int32
    scalars."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    assert list(INPUT_SHAPES) == list(REF_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        want = jax.eval_shape(lambda: ref_steps.input_specs(ref_cfg, REF_SHAPES[name]))
        got = steps.input_specs(cfg, shape)
        assert sorted(got) == sorted(want), name
        for key, spec in got.items():
            if key == "caches":
                assert spec["pos"] == 0
                assert _port_caches_desc(cfg, spec) == _ref_desc(want[key]), name
            else:
                assert spec.device.type == "meta"
                assert _desc(spec.shape, str(spec.dtype).replace("torch.", "")) == \
                    _desc(want[key].shape, want[key].dtype), (name, key)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_train_state_matches_reference(arch):
    """``abstract_params`` and ``abstract_train_state`` (the default AdamW's
    moments, count and step) at full width, on the meta device, leaf for
    leaf against ``jax.eval_shape``."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    want = jax.eval_shape(lambda: ref_steps.abstract_train_state(ref_cfg, ref_steps.default_optimizer()))
    state = steps.abstract_train_state(cfg, steps.default_optimizer())
    like = state["params"]
    assert all(p.device.type == "meta" for p in like.parameters())
    named = dict(like.named_parameters())
    assert _flat(_port_params(like, named, _tensor_desc)) == _ref_desc(want["params"])
    assert _flat(_port_params(like, named, _tensor_desc)) == \
        _flat(_port_params(steps.abstract_params(cfg), dict(steps.abstract_params(cfg).named_parameters()),
                           _tensor_desc))
    for k in ("mu", "nu"):
        got = _flat(_port_params(like, state["opt_state"][k], _tensor_desc))
        assert got == _ref_desc(want["opt_state"][k]), k
    for got, ref in ((state["opt_state"]["count"], want["opt_state"]["count"]), (state["step"], want["step"])):
        assert got.device.type == "meta" and _tensor_desc(False, [got]) == _desc(ref.shape, ref.dtype)


def _engine_inputs(feat, seed=0):
    fs = (feat,) if isinstance(feat, int) else feat
    e = ENGINE
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e["n_clients"], e["n_pad"], *fs)).astype(np.float32)
    y = rng.integers(0, 10, size=(e["n_clients"], e["n_pad"])).astype(np.int32)
    slots = rng.choice(e["n_clients"], size=e["m_slots"], replace=False).astype(np.int32)
    idx = rng.integers(0, e["n_pad"], size=(e["m_slots"], e["n_steps"], e["batch_size"])).astype(np.int32)
    w = (rng.dirichlet(np.ones(e["m_slots"])) * 0.8).astype(np.float32)
    return {"x_all": x, "y_all": y, "slot_ids": slots, "batch_idx": idx, "weights": w,
            "stale_weight": np.float32(0.2)}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_fl_engine_step_matches_reference(case):
    """``make_fl_engine_step`` with ``tests/test_round_engine.py``'s
    settings (8 clients padded to 20 rows, 4 slots, 3 steps of 8, SGD 0.1,
    flat dim-16 and image-shaped (4, 4, 3) clients) on concrete inputs,
    unsharded and over two CPU shards, against the reference's step: the
    new parameters, the flat updates and the losses to atol 1e-5, as
    ``tests/test_torch_engine.py``; the input specs in the reference's
    shapes, in the dtypes the engine stages."""
    feat, sizes = ENGINE_CASES[case]
    e = ENGINE
    ref_specs = ref_steps.fl_engine_input_specs(e["n_clients"], e["m_slots"], e["n_pad"], feat,
                                                e["n_steps"], e["batch_size"])
    specs = steps.fl_engine_input_specs(e["n_clients"], e["m_slots"], e["n_pad"], feat, e["n_steps"],
                                        e["batch_size"])
    assert {k: tuple(v.shape) for k, v in specs.items()} == {k: v.shape for k, v in ref_specs.items()}
    assert all(v.device.type == "meta" for v in specs.values())

    def ref_loss(p, x, y):
        return ref_simple.classification_loss(p, x.reshape(x.shape[0], -1), y)

    def port_loss(p, x, y):  # the port's clients are stacked: (m, B, …)
        return simple.classification_loss(p, x.flatten(-len(specs["x_all"].shape[2:])), y)

    init = {k: np.asarray(v) for k, v in ref_simple.init_mlp(sizes, seed=0).items()}
    data = _engine_inputs(feat)
    want = ref_steps.make_fl_engine_step(ref_loss, ref_sgd(0.1))(
        {k: jnp.asarray(v) for k, v in init.items()}, {k: jnp.asarray(v) for k, v in data.items()})
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    for k in ("y_all", "slot_ids", "batch_idx"):
        batch[k] = batch[k].to(specs[k].dtype)
    for mesh in (None, make_host_mesh(2, 1, device="cpu")):
        got = steps.make_fl_engine_step(port_loss, sgd(0.1), mesh=mesh)(
            simple.params_from_numpy(init, device="cpu"), batch)
        for k in want[0]:
            np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]), atol=1e-5)
        upd = got[1].gather("cpu") if mesh is not None else got[1]
        np.testing.assert_allclose(upd.numpy(), np.asarray(want[1]), atol=1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)


# --------------------------------------------------------------------------
# placements on a 2 × 2 mesh, against the oracle
# --------------------------------------------------------------------------
def _port_specs(cfg, mesh):
    """build_shardings' specs in the reference's layouts, as the oracle dumps them."""
    opt = steps.default_optimizer()
    got = {}
    (state_sh, batch_sh), (out_state, metrics_sh), (state, _) = dryrun.build_shardings(
        cfg, SPEC_SHAPES["train"], mesh, "train", opt)
    assert out_state is state_sh and all(p.spec == () for p in metrics_sh.values())
    like = state["params"]

    def params(placements):
        return _flat(_port_params(like, placements, _placement_spec))

    got["params"] = params(state_sh["params"])
    opt_sh = state_sh["opt_state"]
    got["opt_state"] = {**{f"['{k}']{p}": v for k in ("mu", "nu") for p, v in params(opt_sh[k]).items()},
                        "['count']": _spec(opt_sh["count"].spec)}
    got["step"] = {"": _spec(state_sh["step"].spec)}
    got["batch"] = {f"['{k}']": _spec(v.spec) for k, v in batch_sh.items()}
    got["expert_parallel"] = params(sharding.param_shardings(mesh, like, expert_parallel=True))

    def inputs(batch_sh):
        out = {}
        for k, v in batch_sh.items():
            if k == "caches":
                out.update({f"['caches']{p}": s for p, s in
                            _flat(_ref_cache_layout(cfg, v, _placement_spec)).items()})
            else:
                out[f"['{k}']"] = _spec(v.spec)
        return out

    for kind in ("decode", "decode_odd"):
        (_, batch_sh), (logits_sh, _), _ = dryrun.build_shardings(cfg, SPEC_SHAPES[kind], mesh, "decode", opt)
        got[kind] = inputs(batch_sh)
        got[kind + "_logits"] = _spec(logits_sh.spec)
    (_, batch_sh), (_, cache_sh), _ = dryrun.build_shardings(cfg, SPEC_SHAPES["prefill"], mesh, "prefill", opt)
    got["prefill"] = inputs(batch_sh)
    got["prefill_caches"] = _flat(_ref_cache_layout(cfg, cache_sh, _placement_spec))
    return got


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_build_shardings_match_reference(arch, oracle):
    """Every spec of build_shardings at full width on a 2 × 2 mesh (params
    cleaned where a dim does not divide its axes, the moments, count, step,
    batch, expert-parallel params, decode caches at batch 4 × 32 and 3 × 33
    and the prefill's caches) equals the reference's."""
    want = {k: v if isinstance(v, list) else {p: json.dumps([_entry(e) for e in s]) for p, s in v.items()}
            for k, v in oracle["specs"][arch].items()}
    got = _port_specs(get_config(arch), make_host_mesh(2, 2, device="cpu"))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, list):
            assert got[key] == json.dumps([_entry(e) for e in value]), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_constrain_resolves_as_reference(arch, oracle):
    """Each spec the reference's ``constrain`` handed to
    ``with_sharding_constraint`` in a train loss and a decode step of the
    reduced config, from its tokens and the tensor's shape; ``constrain``
    is the identity on values, and no hints resolve to nothing."""
    mesh = make_host_mesh(2, 2, device="cpu")
    x = torch.zeros(3)
    assert hints.constrain(x, "dp") is x and hints.spec_for((4,), "dp") is None
    records = oracle["constrain"][arch]
    assert records
    with hints.sharding_hints(("data",), mesh=mesh):
        for shape, dims, want in records:
            assert _spec(hints.spec_for(shape, *dims)) == _spec(want), (shape, dims)
    with hints.sharding_hints(("data",)):
        assert hints.spec_for((4, 4), "dp", "model") == (None, None)


def test_param_counts_by_position_match_reference(oracle):
    """qwen3-0.6b at full width: the parameter elements one position holds
    and the replicated ones among them, on 2 × 2, 4 × 1 and 1 × 4 meshes."""
    like = steps.abstract_params(get_config("qwen3-0.6b"))
    named = dict(like.named_parameters())
    assert mdl.param_count(like) == 596_049_920
    for d, m in COUNT_MESHES:
        placements = sharding.param_shardings(make_host_mesh(d, m, device="cpu"), like)
        per = rep = 0
        for n, p in named.items():
            shape = sharding.shard_shape(placements[n], p.shape)
            per += int(np.prod(shape))
            rep += int(np.prod(shape)) if shape == tuple(p.shape) else 0
        assert [per, rep] == oracle["counts"][f"{d}x{m}"], (d, m)


def test_fl_engine_shardings_match_reference(oracle):
    mesh = make_host_mesh(2, 2, device="cpu")
    for key, want in oracle["engine"].items():
        n, m = map(int, key.split("/"))
        specs = steps.fl_engine_input_specs(n, m, ENGINE["n_pad"], (4, 4, 3), ENGINE["n_steps"],
                                            ENGINE["batch_size"])
        got = {k: json.loads(_spec(v.spec)) for k, v in steps.fl_engine_shardings(mesh, specs).items()}
        assert got == {k: [_entry(e) for e in v] for k, v in want.items()}, key


# --------------------------------------------------------------------------
# place / gather
# --------------------------------------------------------------------------
def test_place_blocks_gather_and_bytes():
    """Each position's block is its slices of the tensor (a spec entry's
    axes number the blocks major to minor), positions on one device holding
    the same slices share one tensor, bytes are counted by position, the
    whole tensor gathers back, and a dim its axes do not divide is refused."""
    mesh = make_host_mesh(2, 2, device="cpu")
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    cases = {("model", "data"): [(slice(0, 4), slice(0, 3)), (slice(4, 8), slice(0, 3)),
                                 (slice(0, 4), slice(3, 6)), (slice(4, 8), slice(3, 6))],
             (("data", "model"), None): [(slice(2 * i, 2 * i + 2), slice(0, 6)) for i in range(4)],
             ("data",): [(slice(0, 4), slice(0, 6))] * 2 + [(slice(4, 8), slice(0, 6))] * 2,
             (): [(slice(0, 8), slice(0, 6))] * 4}
    for spec, want in cases.items():
        placed = sharding.place(t, sharding.Placement(mesh, spec))
        for pos, idx in enumerate(want):
            assert placed.index(pos) == idx
            assert torch.equal(placed.blocks[pos], t[idx])
        assert len({id(b) for b in placed.blocks}) == len(set(map(str, want)))
        assert placed.bytes_by_position() == [t[i].numel() * 4 for i in want]
        assert torch.equal(placed.gather("cpu"), t)
        assert sharding.shard_shape(placed.placement, t.shape) == tuple(placed.blocks[0].shape)
    placed.blocks[0].add_(1)
    assert t[0, 0] == 0  # blocks are copies
    with pytest.raises(ValueError, match="not divisible"):
        sharding.place(torch.zeros(6, 3), sharding.Placement(mesh, ("model", "data")))


def test_data_degree_keeps_token_groups_whole():
    mesh = make_host_mesh(4, 1, device="cpu")
    dense = get_config("qwen3-0.6b", reduced=True)
    moe = get_config("deepseek-v2-lite-16b", reduced=True)  # 64-token groups
    assert steps.data_degree(dense, mesh, 4, 7) == 4
    assert steps.data_degree(dense, mesh, 6, 7) == 2  # 4 does not divide 6 rows
    assert steps.data_degree(moe, mesh, 4, 64) == 4
    assert steps.data_degree(moe, mesh, 4, 32) == 2  # a group is 2 rows
    assert steps.data_degree(moe, mesh, 4, 16) == 1  # one group of 64 tokens
    assert steps.data_degree(moe, mesh, 8, 24) == 1  # 192 tokens: 3 groups over 4 blocks


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------
def _run_config(run):
    arch, b, s = RUNS[run]
    ref = dataclasses.replace(ref_get_config(arch, reduced=True), **NARROW)
    port = dataclasses.replace(get_config(arch, reduced=True), **NARROW)
    return ref, port, b, s


def _batches(run, cfg):
    _, b, s = RUNS[run]
    rng = np.random.default_rng(7)
    return [{k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32) for k in ("tokens", "targets")}
            for _ in range(N_STEPS)]


def _init(run):
    ref, port, _, _ = _run_config(run)
    params = jax.tree_util.tree_map(np.asarray, ref_model.init_params(ref, jax.random.PRNGKey(0)))
    return mdl.params_from_numpy(port, params, device="cpu")


def _as_ref_tree(like, tensors) -> dict:
    """Gathered per-name tensors -> the reference's flat ``keystr`` leaves."""
    return _flat(_port_params(like, tensors, lambda st, ts: np.stack([t.numpy() for t in ts])
                              if st else ts[0].numpy()))


def _sharded_state_tree(state, like) -> dict:
    out = {}
    for part, tree in (("params", state["params"]), ("mu", state["opt_state"]["mu"]),
                       ("nu", state["opt_state"]["nu"])):
        got = _as_ref_tree(like, {n: p.gather("cpu") for n, p in tree.items()})
        prefix = "['params']" if part == "params" else f"['opt_state']['{part}']"
        out.update({prefix + k: v for k, v in got.items()})
    return out


def _one_card_state_tree(state, like) -> dict:
    tree = steps.train_state_tree(state)
    out = {}
    for part, t in (("['params']", tree["params"]), ("['opt_state']['mu']", tree["opt_state"]["mu"]),
                    ("['opt_state']['nu']", tree["opt_state"]["nu"])):
        out.update({part + k: np.array(v) for k, v in _flat(t).items()})  # a copy: the step writes in place
    return out


def _limits(mu_steps: list) -> dict:
    """Per entry: the learning rate where some step's gradient entry
    (from μ_t = 0.9 μ_{t−1} + 0.1 g_t) is nonzero and below 10·ε, else 3e-5."""
    out = {}
    for key in mu_steps[0]:
        prev = np.zeros_like(mu_steps[0][key])
        smallest = np.full(prev.shape, np.inf, np.float32)
        for mu in mu_steps:
            g = np.abs(mu[key] - 0.9 * prev) / 0.1
            smallest = np.where(g > 0, np.minimum(smallest, g), smallest)
            prev = mu[key]
        out[key] = np.where(smallest < TINY_GRAD, LR, PARAM_ATOL)
    tiny = sum(int((lim == LR).sum()) for lim in out.values())
    assert tiny < 0.01 * sum(lim.size for lim in out.values()), tiny
    return out


def _check_state(got: dict, want: dict, limits: dict, label) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        lim = limits[key.replace("['params']", "['opt_state']['mu']").replace("['opt_state']['nu']",
                                                                            "['opt_state']['mu']")]
        assert (np.abs(got[key] - w) <= lim).all(), (label, key, float(np.abs(got[key] - w).max()))


@functools.cache
def _sharded_run(run):
    """The port's step over a 2 × 2 CPU mesh from the reference's init: the
    metrics, the state trees after each step and the final placed state
    (run once for both tests of a run)."""
    mesh = make_host_mesh(2, 2, device="cpu")
    _, cfg, b, s = _run_config(run)
    opt = steps.default_optimizer()
    (state_sh, _), _, (like, _) = dryrun.build_shardings(cfg, InputShape("t", s, b, "train"), mesh,
                                                         "train", opt)
    state = sharding.place(steps.init_train_state(_init(run), opt), state_sh)
    step = steps.make_train_step(cfg, opt, mesh=mesh)
    metrics, trees = [], []
    for batch in _batches(run, cfg):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        state, m = step(state, sharding.place(batch, sharding.batch_shardings(mesh, batch)))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(_sharded_state_tree(state, like["params"]))
    return metrics, trees, state


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_step_matches_reference(run, oracle, capsys):
    """The port's step over a 2 × 2 CPU mesh against the reference's jitted
    sharded step: every leaf's block slices at every mesh position, the
    metrics of each step, and the parameters and moments after each."""
    _, cfg, b, s = _run_config(run)
    mesh = make_host_mesh(2, 2, device="cpu")
    arrays = oracle["arrays"]
    for i, batch in enumerate(_batches(run, cfg)):
        for k, v in batch.items():
            np.testing.assert_array_equal(v, arrays[f"{run}/batch{i}/{k}"])
    metrics, trees, state = _sharded_run(run)
    degree = steps.data_degree(cfg, mesh, b, s)
    assert degree == (1 if run == "deepseek_split" else 2)
    assert f"over {degree} of the mesh's 2 data groups" in capsys.readouterr().out
    for got, want in zip(metrics, oracle["runs"][run]):
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[key], want[key], atol=STEP_TOL, err_msg=key)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=STEP_TOL)
    wants = [{k[len(f"{run}/step{i}/"):]: v for k, v in arrays.items() if k.startswith(f"{run}/step{i}/")}
             for i in range(N_STEPS)]
    limits = _limits([{k: v for k, v in w.items() if k.startswith("['opt_state']['mu']")} for w in wants])
    for i, (got, want) in enumerate(zip(trees, wants)):
        assert int(want["['step']"]) == int(want["['opt_state']['count']"]) == i + 1
        _check_state(got, {k: v for k, v in want.items() if k.startswith(STATE_PARTS)}, limits, (run, i))
    assert all(int(b_) == N_STEPS for b_ in state["step"].blocks + state["opt_state"]["count"].blocks)
    # every leaf's block at every mesh position
    like = steps.abstract_params(cfg)
    placed = {"['params']": state["params"], "['opt_state']['mu']": state["opt_state"]["mu"],
              "['opt_state']['nu']": state["opt_state"]["nu"]}
    n = 0
    for prefix, tree in placed.items():
        def slices(stacked, names, tree=tree):
            return types.SimpleNamespace(stacked=stacked, layers=[
                np.array([[(s_.start, s_.stop) for s_ in tree[name].index(pos)] for pos in range(4)])
                for name in names])

        for key, leaf in _flat(_ref_layout(like, slices)).items():
            want = arrays[f"{run}/index/{prefix}{key}"]
            for idx in leaf.layers:
                np.testing.assert_array_equal(idx, want[:, 1:] if leaf.stacked else want, err_msg=key)
            if leaf.stacked:
                assert (want[:, 0] == [0, len(leaf.layers)]).all()
            n += 1
    assert n == 3 * len(mdl.reference_leaves(like))
    for key in ("['opt_state']['count']", "['step']"):
        assert arrays[f"{run}/index/{key}"].shape == (4, 0, 2)


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_step_matches_one_card_step(run):
    """The port's sharded step against its own one-card step from the same
    state and batches, by the same limits; replicated blocks stay one."""
    _, cfg, _, _ = _run_config(run)
    opt = steps.default_optimizer()
    state = steps.init_train_state(_init(run), opt)
    like = steps.abstract_params(cfg)
    step = steps.make_train_step(cfg, opt)
    metrics, trees, mus = [], [], []
    for batch in _batches(run, cfg):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(_one_card_state_tree(state, like))
        mus.append({k: v for k, v in trees[-1].items() if k.startswith("['opt_state']['mu']")})
    got_metrics, got_trees, _ = _sharded_run(run)
    limits = _limits(mus)
    for i, (got, want) in enumerate(zip(got_metrics, metrics)):
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[key], want[key], atol=STEP_TOL, err_msg=key)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=STEP_TOL)
        _check_state(got_trees[i], trees[i], limits, (run, i))
