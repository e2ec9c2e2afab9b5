"""The dry-run's counts: meta against real CPU tensors, the sLSTM shortcut
against the whole loop, every arch and shape through ``run_one``, and the
wrappers' meta path.

Counts (``launch.roofline.CostCounter``) of a step on real CPU tensors —
each kernel on its plain version, whose torch ops the wrapper leaves out —
equal the same step's counts on meta tensors exactly: FLOPs, bytes
accessed, the hand kernels' calls and work, and the bytes moved between
mesh positions, for every reduced config's train, prefill and decode
step, the train step over a 2 × 2 mesh of CPU shards and the federated
round (B2) over two. The sLSTM's loop counted on 2 and 3 steps and
extrapolated equals the loop counted over all its steps. Every reduced
config at the four shapes runs through ``run_one`` on a 2 × 4 meta mesh
(and the federated round through ``run_fl_round``). A meta input to each
wrapper returns an empty meta output without its plain version.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.similarity import ops as sim_ops
from repro_torch.kernels.sketch import ops as sk_ops
from repro_torch.launch import dryrun, dryrun_fl, roofline as rl, sharding, steps
from repro_torch.launch.fl_train import make_fl_round_step
from repro_torch.launch.mesh import make_host_mesh, make_meta_mesh
from repro_torch.models import model as mdl
from repro_torch.models.config import INPUT_SHAPES, InputShape
from repro_torch.models.layers import xlstm
from repro_torch.testing import pin_cpu_threads

pin_cpu_threads()

COUNTS = ("flops", "bytes", "kernels", "moved", "colls", "pairs")
SMALL = dict(batch=2, seq=16)


def _summary(step, args, positions=1):
    with rl.CostCounter(positions, placed=args) as c:
        out = step(*args)
    del out
    return c.summary()


def _batch(cfg, shape, dev):
    """The step's inputs: random on the CPU, empty on meta."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k, v in steps.input_specs(cfg, shape).items():
        if k == "caches":
            out[k] = mdl.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev,
                                    decode_window=steps.decode_window_for(cfg, shape))
        elif dev == "meta":
            out[k] = torch.empty(v.shape, dtype=torch.int64 if v.dtype == torch.int32 else v.dtype,
                                 device="meta")
        elif v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=gen)
        else:
            out[k] = torch.randn(v.shape, generator=gen, dtype=v.dtype)
    return out


def _one_device(cfg, kind, dev):
    shape = InputShape("small", SMALL["seq"], SMALL["batch"], kind)
    params = mdl.init_params(cfg, 0, device="cpu") if dev == "cpu" else steps.abstract_params(cfg)
    batch = _batch(cfg, shape, dev)
    if kind == "train":
        opt = steps.default_optimizer()
        return steps.make_train_step(cfg, opt), (steps.init_train_state(params, opt), batch)
    if kind == "prefill":
        return steps.make_prefill_step(cfg, shape), (params, batch)
    return steps.make_serve_step(cfg, shape), (params, batch)


def _equal_counts(got, want):
    for k in COUNTS:
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_counts_on_cpu_equal_counts_on_meta(arch, kind):
    cfg = get_config(arch, reduced=True)
    cpu, meta = (_summary(*_one_device(cfg, kind, dev)) for dev in ("cpu", "meta"))
    _equal_counts(cpu, meta)
    assert cpu["flops"][0] > 0 and cpu["bytes"][0] > 0
    if kind != "decode" and any(m == "attn" for m, _ in cfg.all_blocks) and cfg.mla is None:
        layers = sum(m == "attn" for m, _ in cfg.all_blocks)
        calls = layers * (2 if kind == "train" and cfg.remat else 1)
        assert cpu["kernels"]["flash_attention"]["calls"] == [calls]


def _meta_mirror(mesh):
    """``mesh`` on meta positions, positions that share a device sharing one."""
    return make_meta_mesh(mesh.devices.shape, mesh.axis_names, cards=len(set(map(str, mesh.devices.flat))))


def test_sharded_train_counts_on_cpu_equal_meta():
    cfg = get_config("qwen3-0.6b", reduced=True)
    shape = InputShape("small", SMALL["seq"], 4, "train")
    opt = steps.default_optimizer()
    got = {}
    for dev in ("cpu", "meta"):
        mesh = make_host_mesh(2, 2, device="cpu")
        mesh = mesh if dev == "cpu" else _meta_mirror(mesh)
        (state_sh, batch_sh), _, _ = dryrun.build_shardings(cfg, shape, mesh, "train", opt)
        params = mdl.init_params(cfg, 0, device="cpu") if dev == "cpu" else steps.abstract_params(cfg)
        state = sharding.place(steps.init_train_state(params, opt), state_sh)
        batch = sharding.place(_batch(cfg, shape, dev), batch_sh)
        got[dev] = _summary(steps.make_train_step(cfg, opt, mesh=mesh), (state, batch), 4)
    _equal_counts(got["cpu"], got["meta"])
    calls = got["cpu"]["kernels"]["flash_attention"]["calls"]
    per = cfg.n_layers * (2 if cfg.remat else 1)  # twice a layer under remat
    assert calls == [per, 0, per, 0]
    assert all(got["cpu"]["moved"]) and got["cpu"]["colls"]["all-gather"]["bytes"][2] > 0


def test_fl_round_counts_on_cpu_equal_meta():
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), dtype="float32")
    m, n_local, b, s = 4, 2, 2, 8
    got = {}
    for dev in ("cpu", "meta"):
        mesh = make_host_mesh(2, 1, device="cpu")
        mesh = mesh if dev == "cpu" else _meta_mirror(mesh)
        step = make_fl_round_step(cfg, 0.05, n_local, with_updates=True, mesh=mesh)
        params = mdl.init_params(cfg, 0, device="cpu") if dev == "cpu" else steps.abstract_params(cfg)
        gen = torch.Generator().manual_seed(1)
        toks = (torch.randint(0, cfg.vocab_size, (m, n_local, b, s), generator=gen) if dev == "cpu"
                else torch.empty((m, n_local, b, s), dtype=torch.int64, device="meta"))
        weights = torch.full((m,), 1 / m, device=dev)
        got[dev] = _summary(step, (params, toks, toks, weights), 2)
    _equal_counts(got["cpu"], got["meta"])
    assert got["cpu"]["kernels"]["aggregate"]["calls"] == [1, 1]
    assert got["cpu"]["colls"]["all-reduce"]["bytes"][0] > 0 and all(got["cpu"]["moved"])


@pytest.mark.parametrize("kind,remat", (("train", False), ("train", True), ("prefill", False)))
def test_slstm_shortcut_equals_the_whole_loop(kind, remat):
    """``count_step``'s counts of a model with sLSTM blocks (the loop cut to
    2 and 3 steps, extrapolated) equal a meta run over all S steps, with
    remat's recompute too."""
    cfg = dataclasses.replace(get_config("xlstm-125m", reduced=True), remat=remat)
    seq = 24
    shape = InputShape("loop", seq, 2, kind)

    def make():
        params = steps.abstract_params(cfg)
        batch = _batch(cfg, shape, "meta")
        if kind == "train":
            opt = steps.default_optimizer()
            return steps.make_train_step(cfg, opt), (steps.init_train_state(params, opt), batch)
        return steps.make_prefill_step(cfg, shape), (params, batch)

    whole = _summary(*make())
    cut = dryrun.count_step(*make(), 1, cfg, seq, kind)
    _equal_counts(cut, whole)
    with xlstm.counted_loop_steps(2):
        two = _summary(*make())
    assert two["bytes"] < whole["bytes"]  # the cut did cut


@pytest.fixture
def small_dryrun(monkeypatch):
    """The dry-run on reduced configs over a 2 × 4 meta mesh in place of
    the production one."""
    for mod in (dryrun, dryrun_fl):
        monkeypatch.setattr(mod, "get_config", lambda arch: get_config(arch, reduced=True))
        monkeypatch.setattr(mod, "make_production_mesh",
                            lambda multi_pod=False: make_meta_mesh((2, 4)))


@pytest.mark.parametrize("shape", tuple(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_run_one_counts_every_arch_and_shape(arch, shape, tmp_path, small_dryrun):
    rec = dryrun.run_one(arch, shape, multi_pod=False, variants=[], out_dir=str(tmp_path))
    per = rec["per_position"]
    assert rec["kind"] == INPUT_SHAPES[shape].kind and rec["chips"] == 8
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0 and min(per["args"]) > 0
    assert rec["n_params"] >= rec["n_params_active"] > 0
    assert rec["hbm_per_chip_gb"] >= 0 and rec["dominant"] in ("compute", "memory", "collective")
    if rec["kind"] == "train":
        assert rec["coll_bytes_per_chip"] > 0 and min(per["moved"]) > 0
    assert (tmp_path / f"{arch}__{shape}__2x4__baseline.json").exists()


def test_fl_round_record_moves_bytes_and_feeds_the_planner(tmp_path, small_dryrun):
    rec = dryrun_fl.run_fl_round("qwen3-0.6b", n_local=2, seq_len=16, global_batch=8,
                                 planner="async", out_dir=str(tmp_path))
    params = steps.abstract_params(get_config("qwen3-0.6b", reduced=True))
    d = sum(p.numel() for p in params.parameters())
    assert rec["m_clients"] == 2 and rec["planner_feed_bytes"] == 2 * d * 4
    assert rec["coll_bytes_per_chip_per_round"] > 0 and rec["flops_per_chip_per_local_step"] > 0
    assert rec["per_position"]["kernels"]["aggregate"]["calls"] == [1, 0, 0, 0, 1, 0, 0, 0]


def _spy(monkeypatch, module, name):
    def boom(*a, **k):
        raise AssertionError(f"{name} ran on a meta input")
    monkeypatch.setattr(module, name, boom)


@pytest.mark.parametrize("kernel", ("flash_attention", "aggregate", "gram", "l1", "srp"))
def test_a_meta_input_never_runs_the_plain_version(kernel, monkeypatch):
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    for module, name in ((fa_ops, "flash_attention_plain"), (agg_ops, "aggregate_ref"),
                         (sim_ops, "gram_ref"), (sim_ops, "l1_ref"), (sk_ops, "sketch_srp_plain")):
        _spy(monkeypatch, module, name)
    with rl.CostCounter() as c:
        if kernel == "flash_attention":
            out, want = fa_ops.flash_attention_padded(meta(2, 9, 4, 32), meta(2, 9, 2, 32),
                                                      meta(2, 9, 2, 32)), (2, 9, 4, 32)
            work = fa_ops.work(2, 9, 9, 4, 2, 32)
        elif kernel == "aggregate":
            out, want, work = agg_ops.aggregate_flat(meta(5, 77), meta(5)), (77,), agg_ops.work(5, 77)
        elif kernel == "srp":
            out, want, work = sk_ops.srp_sketch(meta(6, 300), 16, 3), (6, 16), sk_ops.work(6, 300, 16)
        else:
            out, want = sim_ops.pairwise_sums(meta(7, 40), kernel), (7, 7)
            work = sim_ops.work(7, 40, kernel)
    assert out.device.type == "meta" and tuple(out.shape) == want
    assert c.kernels[kernel] == {"calls": [1], "flops": [work[0]], "bytes": [work[1]]}
