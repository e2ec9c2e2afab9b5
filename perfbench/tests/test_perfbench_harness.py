"""CPU tests of the benchmark harness (``perfbench``): its data files, its
frozen arithmetic, its references against the port at tiny widths, the
faults its comparison catches, and what it refuses.

The card's own checks (the control at a cell's size) are in
``test_perfbench_card.py`` and skip here.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.testing import pin_cpu_threads, thread_env  # noqa: E402

pin_cpu_threads()

from perfbench import check, control, generate, run, spec, trace, work  # noqa: E402
from perfbench.driver import port_config  # noqa: E402
from perfbench.reference import federated, lm, sampling, sketch  # noqa: E402
from perfbench.tests._tiny import TINY, run_on, tiny_cell  # noqa: E402

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")



def run_cpu(cell: dict) -> tuple[bool, dict]:
    return run_on(cell, CPU)


# --------------------------------------------------------------------------
# the data files, found by name
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_its_config_mix_and_limits(name):
    c = spec.cell(name)
    assert c["config_file"]["name"] == c["config"]
    assert c["traffic_file"]["m"] <= c["traffic_file"]["n_clients"]
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s", "tokens_per_s"}
    assert c["per_layer"]
    moved = {m["name"] for m in c["end_to_end"]}
    assert all(m["moves"] in moved for m in c["per_layer"])
    assert set(c["limits"]) >= {"first_gap", "change_gap", "draw_mismatch"}


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_file_loads_by_name(name):
    mod = run.readers([name])[name]
    entry = [m for m in BENCH["per_layer"] if m["name"] == name][0]
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
        entry["unit"], entry["layer"], entry["moves"], entry["source"])
    if name.endswith("_roofline"):
        assert trace.patterns(name), f"{name} reads no device-op names"


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        assert set(c["reduced"]) <= set(spec.load_json(ROOT / c["file"]))
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_port_config_it_runs(name):
    from repro_torch.models import model as mdl

    cfg = spec.config(name)
    mc = port_config(cfg)
    a = spec.arch(cfg)
    named = dict(mdl.init_params(mc, 0, device="meta").named_parameters())
    leaves = lm.flat_leaves(a)
    assert {n: tuple(s) for n, s, _ in leaves} == {n: tuple(p.shape) for n, p in named.items()}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_flat_order_is_the_port_flat_order(name):
    from repro_torch.models import model as mdl

    cfg = spec.config(name)
    like = mdl.init_params(port_config(cfg), 0, device="meta")
    assert [n for n, _ in mdl.flat_runs(like)] == [n for n, _, _ in lm.flat_leaves(spec.arch(cfg))]


# --------------------------------------------------------------------------
# the traffic generator
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in BENCH["workloads"]}))
def test_token_streams_repeat_for_a_seed_and_differ_across_seeds(mix):
    t = spec.traffic(mix)
    t["stream"]["batches_per_client"] = 16
    a = generate.token_table(t, 151936, 2**31 + 5, CPU)
    b = generate.token_table(t, 151936, 2**31 + 5, CPU)
    c = generate.token_table(t, 151936, 2**31 + 6, CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    toks, tgts = generate.batches(a, t, 151936, [(3, [0]), (5, [1])])
    assert toks.shape == (2, 1, t["local_batch"], t["seq_len"])
    assert torch.equal(tgts, (toks + 31) % 151936)
    rows = toks.reshape(-1, t["seq_len"])
    assert len({tuple(r[:4].tolist()) for r in rows}) == rows.shape[0]


def test_theta0_repeats_and_scales_by_fan_in():
    a = spec.arch(TINY["qwen2-1.5b"])
    leaves = lm.flat_leaves(a)
    x, y = generate.theta0(leaves, 9, CPU), generate.theta0(leaves, 9, CPU)
    assert torch.equal(x, y)
    v = lm.views(x, leaves)
    assert torch.all(v["final_norm.scale"] == 1) and torch.all(v["blocks.0.attn.bq"] == 0)
    assert abs(float(v["embed"].std()) - 64 ** -0.5) < 0.01


# --------------------------------------------------------------------------
# the frozen arithmetic
# --------------------------------------------------------------------------
def test_frozen_work_gives_the_kernel_table_bounds():
    d = 1_543_714_304
    ops, nbytes = work.sketch_work(8, d, 64)
    assert round(1e3 * ops / 67e12, 6) == 23.593484  # B3's bound, f32 operations
    _, nbytes = work.aggregate_work(8, d)
    assert round(1e3 * nbytes / work.PEAK_BYTES, 6) == 16.589169  # B2's, bytes
    ops, _ = work.flash_work(4, 1000, 1000, 12, 2, 128)
    assert round(1e3 * ops / work.PEAK_FLOPS, 6) == 0.012425  # B4 at the serve shape
    assert work.least_time(ops, 0) == ops / work.PEAK_FLOPS


@pytest.mark.parametrize("name,total", [("qwen2-1.5b", 1_543_714_304)])
def test_frozen_parameter_counts(name, total):
    a = spec.arch(spec.config(name))
    leaves = [(n, s) for n, s, _ in lm.flat_leaves(a)]
    assert work.active_params(leaves) == (total, total)
    assert work.model_flops(total, 8192, "train") == 6.0 * total * 8192
    # a routed expert's leaf counts at top_k / n_routed
    assert work.active_params([("blocks.1.moe.e_up", (64, 8, 4)), ("embed", (10, 8))], 6, 64) == (2128, 272)


# --------------------------------------------------------------------------
# the references against the port
# --------------------------------------------------------------------------
def test_sketch_columns_equal_the_port_sketch_and_the_uint32_hash():
    from repro_torch.kernels.sketch.ref import sketch_srp_plain

    u = torch.randn(70_001, generator=torch.Generator().manual_seed(3))
    seed = 2**31 + 77
    for cols in ([0, 9, 40, 63], list(range(64))):  # one packed byte of signs, and eight
        got = sketch.Signs(u.numel(), cols, seed, 64, CPU).columns(u).numpy()
        want = sketch_srp_plain(u[None], 64, seed)[0, cols].double().numpy()
        assert np.allclose(got, want, rtol=1e-5, atol=1e-4)
    k = np.arange(1000, dtype=np.uint32)
    h = (k * np.uint32(sketch.K_SALT)) ^ np.uint32(((9 * sketch.J_SALT) ^ (seed * sketch.SEED_SALT)) & sketch.MASK)
    for sh, c in ((16, sketch.C1), (13, sketch.C2)):
        h = (h ^ (h >> np.uint32(sh))) * np.uint32(c)
    h = h ^ (h >> np.uint32(16))
    kk = torch.arange(1000, dtype=torch.int32) * sketch._i32(sketch.K_SALT)
    salt = sketch._i32(((9 * sketch.J_SALT) & sketch.MASK) ^ ((seed * sketch.SEED_SALT) & sketch.MASK))
    assert np.array_equal(sketch.mix32(kk ^ salt).numpy().astype(np.uint32), h)


@pytest.mark.parametrize("trial", range(3))
def test_sampling_reference_equals_the_port_plan_and_draw(trial):
    from repro_torch.core.samplers.algorithm2 import build_plan_algorithm2
    from repro_torch.core.samplers.md import MDSampler
    from repro_torch.core.types import ClientPopulation

    rng = np.random.default_rng(trial)
    G = rng.standard_normal((32, 64)).astype(np.float32)
    G[rng.choice(32, 20, replace=False)] = 0.0
    pop = ClientPopulation(np.full(32, 1000))
    plan = build_plan_algorithm2(pop, 8, torch.from_numpy(G), distance_fn="numpy")
    assert np.array_equal(plan.r_tokens, sampling.algorithm2_plan(G, pop.n_samples, 8))
    md = MDSampler(pop, 8, seed=trial)
    mine = np.random.default_rng(trial)
    for t in range(4):
        assert np.array_equal(md.sample(t).clients, sampling.draw(sampling.md_plan(pop.n_samples, 8), mine))


@pytest.mark.parametrize("name", list(TINY))
def test_reference_loss_and_gradient_equal_the_port(name):
    from repro_torch.models import model as mdl

    cfg = TINY[name]
    mc, a = port_config(cfg), spec.arch(cfg)
    leaves = lm.flat_leaves(a)
    theta = generate.theta0(leaves, 11, CPU)
    like = mdl.init_params(mc, 0, device="meta")
    port = mdl.lm_views(torch.empty(theta.numel()), like)
    with torch.no_grad():
        for n, p in port.named_parameters():
            p.copy_(lm.views(theta, leaves)[n])
    port.requires_grad_(True)
    toks = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1))
    tgts = (toks + 31) % 256
    want, _ = mdl.loss_fn(mc, port, toks, tgts)
    gw = dict(zip([n for n, _ in port.named_parameters()],
                  torch.autograd.grad(want, list(port.parameters()))))
    flat = theta.clone().requires_grad_(True)
    got = lm.Model(a).loss(lm.views(flat, leaves), toks, tgts)
    (g,) = torch.autograd.grad(got, flat)
    assert abs(float(got) - float(want)) < 1e-5
    for n, v in lm.views(g, leaves).items():
        assert torch.allclose(v, gw[n], rtol=1e-3, atol=1e-6), n


# --------------------------------------------------------------------------
# the whole comparison at tiny widths: sound, the control, and faults
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_sound_tiny_run_is_correct(name):
    ok, numbers = run_cpu(tiny_cell(name))
    assert ok, numbers


def _md_cell() -> dict:
    """The first cell's mix under MD sampling (the store, B3 and the planner
    bypassed), as a later traffic file could state it; the limits of the
    numbers it has."""
    cell = tiny_cell(CELLS[0])
    t = dict(cell["traffic_file"], sampler={"name": "md", "options": {}}, planner={"mode": "sync"})
    lim = {k: v for k, v in cell["limits"].items() if k not in ("sketch_gap", "plan_mismatch")}
    return {**cell, "traffic_file": t, "limits": lim}


@pytest.mark.parametrize("fault", [None, "draw"])
def test_the_md_branch_judges_every_draw_of_the_window(fault, monkeypatch):
    from repro_torch.core.samplers.base import ClientSampler

    if fault == "draw":
        real = ClientSampler._draw_from_plan
        calls = []

        def altered(self, plan, available=None):
            res = real(self, plan, available)
            calls.append(1)
            if len(calls) > 2:  # a round of the window, past the two checked ones
                res.clients[0] = (res.clients[0] + 1) % self.population.n_clients
            return res

        monkeypatch.setattr(ClientSampler, "_draw_from_plan", altered)
    ok, numbers = run_cpu(_md_cell())
    assert "sketch_gap" not in numbers and ok == (fault is None), numbers


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_fails_the_comparison(name):
    cell = tiny_cell(name)
    traffic, a = cell["traffic_file"], spec.arch(cell["config_file"])
    rounds = control.schedule(traffic, 5)
    kw = dict(device=CPU, signs=federated.signs_for(a, traffic, 5, CPU))
    ref = federated.run(a, traffic, 5, rounds, **kw)
    numbers = control.numbers(ref, federated.run(a, traffic, 5, rounds, quant="fp8", **kw), traffic)
    judged = control.judged(numbers, cell["limits"])
    assert not judged["correct"], judged


def _local_sgd_unchanged(orig):
    def make(cfg, lr, n):
        from repro_torch.models import model as mdl

        def local_sgd(params, tokens, targets):
            loss, _ = mdl.loss_fn(cfg, params, tokens[0], targets[0])
            return params, loss.detach()

        return local_sgd
    return make


def _local_sgd_half(orig):
    def make(cfg, lr, n):
        real = orig(cfg, lr, n)

        def local_sgd(params, tokens, targets):
            half = tokens.shape[1] // 2
            return real(params, tokens[:, :half], targets[:, :half])

        return local_sgd
    return make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "draw", "sketch", "sketch_column",
                                   "store_row"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core.samplers.base import ClientSampler
    from repro_torch.fl import gradient_store
    from repro_torch.launch import fl_train

    if fault in ("unchanged", "half_batch"):
        wrap = _local_sgd_unchanged if fault == "unchanged" else _local_sgd_half
        monkeypatch.setattr(fl_train, "make_local_sgd", wrap(fl_train.make_local_sgd))
    elif fault == "draw":  # an answer altered where it is produced: urn 0's client
        real = ClientSampler._draw_from_plan

        def altered(self, plan, available=None):
            res = real(self, plan, available)
            res.clients[0] = (res.clients[0] + 1) % self.population.n_clients
            return res

        monkeypatch.setattr(ClientSampler, "_draw_from_plan", altered)
    elif fault in ("sketch", "sketch_column"):  # B3's first row, or its last column, scaled
        real_rows = gradient_store.GradientStore._rows

        def scaled(self, ids, updates):
            out = []
            for i, v in real_rows(self, ids, updates):
                v = v.clone()
                if fault == "sketch":
                    v[0] *= 1.5
                else:
                    v[:, -1] *= 1.5
                out.append((i, v))
            return out

        monkeypatch.setattr(gradient_store.GradientStore, "_rows", scaled)
    else:  # a row of a client not yet observed written beside the scatter
        real_update = gradient_store.GradientStore.update

        def stray(self, client_ids, updates):
            real_update(self, client_ids, updates)
            empty = torch.nonzero((self._G == 0).all(dim=1)).flatten()
            if empty.numel():
                self._G[empty[0]] = 1e-3

        monkeypatch.setattr(gradient_store.GradientStore, "update", stray)
    ok, numbers = run_cpu(tiny_cell("qwen2-1.5b.alg2_srp"))
    assert not ok, numbers


def test_sketch_gap_reads_every_entry_of_the_store():
    rows = [(0, 2, np.array([1.0, -2.0, 3.0]), 1.0), (1, 5, np.array([0.5, 0.5, 0.5]), 1.0),
            (1, 2, np.array([2.0, 2.0, 2.0]), 1.0)]
    want = check.latest_rows(rows, 2)
    assert sorted(want[0]) == [2] and sorted(want[1]) == [2, 5]
    stores = check.stores_of(rows, 2, 8, 3)
    assert check.sketch_gap(stores, want) == 0.0
    off = [G.copy() for G in stores]
    off[1][5, 2] += 0.25  # one entry of one column
    assert check.sketch_gap(off, want) == 0.25
    off = [G.copy() for G in stores]
    off[0][5, 0] = 1e-9  # a client not observed by round 0
    assert check.sketch_gap(off, want) == float("inf")


# --------------------------------------------------------------------------
# what the command refuses
# --------------------------------------------------------------------------
def test_the_command_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for a machine without one")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=thread_env(dict(os.environ)))
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, found
    if "reference" in path.parts:
        assert "repro_torch" not in found, found


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch.models.model", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.fl", "jaxlib.xla_client", "flax"]) == ["flax", "jaxlib", "repro"]


class _Event:
    """A Kineto event's accessors, as ``trace.Trace`` reads them."""

    def __init__(self, name, device, start, dur, annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if device else DeviceType.CPU, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_trace_reduction_attributes_ops_to_spans_and_unions_overlaps():
    ev = [
        _Event("round", False, 0, 1000), _Event("round_step", False, 0, 600),
        _Event("observe_updates", False, 600, 400), _Event("aten::mm", False, 20, 70),
        _Event("round_step", True, 0, 600, annotation=True),  # a span's device mirror
        _Event("gemm_kernel", True, 100, 200), _Event("aggregate_vec2", True, 400, 100),
        _Event("srp_partial", True, 650, 200), _Event("srp_reduce", True, 700, 200),
        _Event("Stream Sync", True, 900, 100),
    ]
    tr = trace.Trace(ev)
    assert tr.window_s == 1e-6 and tr.busy_s == 550e-9
    assert tr.op_seconds(["srp_partial", "srp_reduce"]) == (250e-9, 2)
    local = tr.mask(span="round_step") & ~tr.mask(names=["aggregate_vec2"])
    assert tr.busy_seconds(local) == 200e-9
    assert tr.top_ops(1) == [["gemm_kernel", 200e-9]]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["round_step: host code between ops", 150e-9]  # 500–650, no host op
    assert ["round_step: aten::mm", 100e-9] in gaps  # 0–100, under the op at 20–90
