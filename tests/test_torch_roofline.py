"""The port's roofline, dry-run bookkeeping and report against the JAX reference's.

In this process: ``active_params`` for the 10 full configs (the reference
takes ``jax.eval_shape``'s abstract parameters), ``model_flops``, the
``Roofline``'s formulas and ``to_dict`` keys, the records' keys (the
reference's ``run_one`` / ``run_fl_round`` read from their source), the
H100 data sheet's constants and no TPU constant in the port, the report's
markdown from both packages' ``dryrun_table`` / ``roofline_table`` /
``main`` on one list of the port's records, and the roofline runner's rows
from both packages' ``bench_dryrun_roofline`` on one directory.

In one subprocess, whose import of the reference's ``launch/dryrun.py``
gives it 512 placeholder host devices: ``apply_variants`` and
``_with_repeats`` for every arch and variant, the production meshes'
``batch_axes`` / ``data_parallel_degree`` / ``leading_batch_spec`` /
``mesh_chips``, ``planner_from_spec`` on four specs, and
``memory_analysis()``'s argument and output bytes of reduced qwen3-0.6b and
deepseek-v2-lite-16b train steps and a qwen3 decode compiled by the
reference's ``_compile`` over ``make_host_mesh(2, 4)`` (Auto axes), held
to the port's bytes by position on a 2 × 4 meta mesh.
"""
import ast
import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

from repro.configs import ARCH_NAMES, get_config as ref_get_config
from repro.launch import report as ref_report
from repro.launch import roofline as ref_rl
from repro.launch import steps as ref_steps
from repro_torch.benchmarks import bench_dryrun_roofline
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, dryrun_fl, report, roofline as rl, steps
from repro_torch.launch.mesh import (
    batch_axes,
    data_parallel_degree,
    leading_batch_spec,
    make_meta_mesh,
    make_production_mesh,
    mesh_chips,
)
from repro_torch.models.config import InputShape
from repro_torch.testing import pin_cpu_threads, thread_env

pin_cpu_threads()

ROOT = os.path.join(os.path.dirname(__file__), "..")
BYTES_CASES = {"qwen3_train": ("qwen3-0.6b", ["t", 32, 8, "train"]),
               "deepseek_train": ("deepseek-v2-lite-16b", ["t", 32, 8, "train"]),
               "qwen3_decode": ("qwen3-0.6b", ["d", 32, 8, "decode"])}
SPECS = {"md": {"sampler": {"name": "md", "m": 4}},
         "algorithm2_sync": {"sampler": {"name": "algorithm2", "m": 4}, "planner": {"mode": "sync"}},
         "algorithm2_async": {"sampler": {"name": "algorithm2", "m": 4},
                              "planner": {"mode": "async"}},
         "importance": {"sampler": {"name": "importance", "m": 4}}}

ORACLE = r"""
import dataclasses, json, sys
from repro.launch import dryrun as D  # 512 placeholder host devices, before jax starts
from repro.configs import ARCH_NAMES, get_config
from repro.launch.dryrun_fl import planner_from_spec
from repro.launch.mesh import (batch_axes, data_parallel_degree, leading_batch_spec,
                               make_host_mesh, make_production_mesh, mesh_chips)
from repro.models.config import InputShape

cases, specs = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {"variants": {}, "repeats": {}, "mesh": {}, "bytes": {}, "planner": {}}
for arch in ARCH_NAMES:
    cfg = get_config(arch)
    for v in [None, *D.VARIANTS]:
        out["variants"][f"{arch}|{v}"] = dataclasses.asdict(D.apply_variants(cfg, [] if v is None else [v]))
    for n in (1, 2):
        out["repeats"][f"{arch}|{n}"] = dataclasses.asdict(D._with_repeats(cfg, n))
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out["mesh"][str(mp)] = {"batch_axes": list(batch_axes(m)), "dp": data_parallel_degree(m),
                            "lead": [list(e) if isinstance(e, tuple) else e
                                     for e in leading_batch_spec(m, 2)],
                            "chips": mesh_chips(m), "shape": dict(m.shape)}
for key, spec in specs.items():
    out["planner"][key] = planner_from_spec(json.dumps(spec))
import jax
mesh = make_host_mesh(2, 4)
for key, (arch, shape) in cases.items():
    cfg, shape = get_config(arch, reduced=True), InputShape(*shape)
    compiled, kind, _ = D._compile(cfg, shape, mesh, expert_parallel=False)
    mem = compiled.memory_analysis()
    _, out_sh, (_, specs) = D.build_shardings(cfg, shape, mesh, kind, D.default_optimizer())
    pos = sum(l.size * l.dtype.itemsize for p, l in jax.tree_util.tree_flatten_with_path(specs)[0]
              if jax.tree_util.keystr(p).endswith("['pos']"))
    out["bytes"][key] = [mem.argument_size_in_bytes, mem.output_size_in_bytes,
                         len(jax.tree_util.tree_leaves(out_sh)), pos]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _oracle_run(tmp_path_factory):
    """The oracle subprocess, started when the module's first test starts."""
    path = str(tmp_path_factory.mktemp("roofline") / "oracle.json")
    env = thread_env(dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src")))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", ORACLE, path, json.dumps(BYTES_CASES),
                             json.dumps(SPECS)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def oracle(_oracle_run):
    proc, path = _oracle_run
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(path) as f:
        return json.load(f)


def _plain(x):
    return json.loads(json.dumps(x))


# --------------------------------------------------------------------------
# in this process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_params_equal_reference(arch):
    cfg = ref_get_config(arch)
    want = ref_rl.active_params(ref_steps.abstract_params(cfg), cfg)
    assert rl.active_params(steps.abstract_params(get_config(arch)), get_config(arch)) == want


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_model_flops_equal_reference(kind):
    for n, tokens in ((596_049_920, 1_048_576), (2_660_000_000, 128), (7, 3)):
        assert rl.model_flops(n, tokens, kind) == ref_rl.model_flops(n, tokens, kind)


def test_roofline_follows_the_reference_formulas_at_h100_peaks():
    fields = dict(arch="a", shape="s", mesh="16x16", chips=256, flops_per_chip=3.1e14,
                  bytes_per_chip=2.2e12, coll_bytes_per_chip=7.7e10,
                  coll_detail={k: {"count": 1, "bytes": 1.0} for k in rl.COLLECTIVES},
                  model_flops_global=5.0e16, arg_bytes_per_chip=1.0, temp_bytes_per_chip=2.0,
                  out_bytes_per_chip=3.0)
    got, want = rl.Roofline(**fields), ref_rl.Roofline(**fields)
    assert list(got.to_dict()) == list(want.to_dict())
    assert got.t_compute == fields["flops_per_chip"] / 989e12
    assert got.t_memory == fields["bytes_per_chip"] / 3.35e12
    assert got.t_collective == fields["coll_bytes_per_chip"] / 450e9
    assert got.utility_ratio == want.utility_ratio
    terms = {"compute": got.t_compute, "memory": got.t_memory, "collective": got.t_collective}
    assert got.dominant == max(terms, key=terms.get) and got.bound_time == max(terms.values())
    assert rl.COLLECTIVES == ref_rl._COLLECTIVES


def test_constants_are_the_h100_data_sheet_and_no_tpu_number_is_left():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9)\b|\b197\s*TFLOP|v5e")
    src = os.path.join(ROOT, "src", "repro_torch")
    hits = [os.path.join(d, f) for d, _, fs in os.walk(src) for f in fs
            if f.endswith(".py") and tpu.search(open(os.path.join(d, f)).read())]
    assert hits == []


def _ref_record_keys(path: str, func: str) -> list:
    """The keys of the record ``func`` writes in the reference's ``path``:
    ``rec.update(...)``'s keywords after ``Roofline.to_dict()``'s, or the
    literal ``rec = {...}``'s."""
    tree = ast.parse(open(os.path.join(ROOT, "src", "repro", "launch", path)).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["rec"]):
            return [k.value for k in node.value.keys]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"):
            base = ref_rl.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0, {}, 1.0).to_dict()
            return list(base) + [k.arg for k in node.keywords]
    raise AssertionError(f"no record in {func}")


def small_dryrun(mp) -> None:
    """The dry-run on reduced configs over a 2 × 4 meta mesh in place of
    the production one."""
    for mod in (dryrun, dryrun_fl):
        mp.setattr(mod, "get_config", lambda arch: get_config(arch, reduced=True))
        mp.setattr(mod, "make_production_mesh", lambda multi_pod=False: make_meta_mesh((2, 4)))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A list of the port's records on the 2 × 4 meta mesh: counted, placed
    only and a federated round."""
    path = tmp_path_factory.mktemp("records")
    kw = dict(multi_pod=False, out_dir=str(path))
    with pytest.MonkeyPatch.context() as mp:
        small_dryrun(mp)
        recs = [dryrun.run_one("qwen3-0.6b", "train_4k", variants=[], **kw),
                dryrun.run_one("qwen2-1.5b", "prefill_32k", variants=[], **kw),
                dryrun.run_one("deepseek-v2-lite-16b", "decode_32k", variants=[], **kw),
                dryrun.run_one("qwen3-0.6b", "decode_32k", variants=["fused_ce"], **kw),
                dryrun.run_one("qwen2-1.5b", "long_500k", variants=[], lower_only=True, **kw),
                dryrun_fl.run_fl_round("qwen3-0.6b", n_local=2, seq_len=32, global_batch=8,
                                       planner="sync", out_dir=str(path))]
    return path, recs


def test_record_keys_equal_the_reference(records):
    _, recs = records
    want = _ref_record_keys("dryrun.py", "run_one")
    for rec in recs[:-1]:
        assert list(rec) == want + ["per_position"]
    assert list(recs[-1]) == _ref_record_keys("dryrun_fl.py", "run_fl_round") + ["per_position"]
    names = sorted(os.listdir(records[0]))
    assert "qwen3-0.6b__train_4k__2x4__baseline.json" in names
    assert "qwen3-0.6b__decode_32k__2x4__fused_ce.json" in names
    assert "qwen3-0.6b__fl_round_N2__2x4__baseline+planner-sync.json" in names


def test_report_renders_the_reference_markdown(records, capsys, monkeypatch):
    path, recs = records
    recs = [_plain(r) for r in recs]
    for variants in ("baseline", "fused_ce"):
        assert report.dryrun_table(recs, variants=variants) == ref_report.dryrun_table(
            recs, variants=variants)
        assert report.roofline_table(recs, mesh="2x4", variants=variants) == \
            ref_report.roofline_table(recs, mesh="2x4", variants=variants)
    assert report.load(str(path)) == ref_report.load(str(path))
    assert report.dryrun_table(recs).count("\n") == 5  # header, rule, four records
    assert "(lower-only)" in report.dryrun_table(recs)
    capsys.readouterr()
    printed = []
    for mod in (ref_report, report):
        monkeypatch.setattr(sys, "argv", ["report", "--dir", str(path), "--mesh", "2x4"])
        mod.main()
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0] and "| qwen3-0.6b | train_4k | 2x4 | train |" in printed[0]


def test_roofline_runner_rows_equal_the_reference(records, capsys, monkeypatch):
    if ROOT not in sys.path:  # the reference's runner lives in the repo's benchmarks/
        monkeypatch.syspath_prepend(ROOT)
    from benchmarks import bench_dryrun_roofline as ref_bench

    path, _ = records
    work = path.parent / "runner"
    (work / "experiments").mkdir(parents=True)
    os.symlink(path, work / "experiments" / "dryrun")
    monkeypatch.chdir(work)
    ref_bench.main()
    want = capsys.readouterr().out
    bench_dryrun_roofline.main(["--dir", str(path)])
    assert capsys.readouterr().out == want
    assert want.count("\n") == 6 and "roofline/qwen3-0.6b/fl_round_N2/2x4/baseline" in want


# --------------------------------------------------------------------------
# against the oracle subprocess
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_variants_and_repeats_equal_reference(arch, oracle):
    cfg = get_config(arch)
    for v in [None, *dryrun.VARIANTS]:
        got = dataclasses.asdict(dryrun.apply_variants(cfg, [] if v is None else [v]))
        assert _plain(got) == oracle["variants"][f"{arch}|{v}"], v
    for n in (1, 2):
        assert _plain(dataclasses.asdict(dryrun._with_repeats(cfg, n))) == oracle["repeats"][f"{arch}|{n}"]


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_helpers_equal_reference(multi_pod, oracle):
    m = make_production_mesh(multi_pod=multi_pod)
    want = oracle["mesh"][str(multi_pod)]
    assert list(batch_axes(m)) == want["batch_axes"] and dict(m.shape) == want["shape"]
    assert data_parallel_degree(m) == want["dp"] and mesh_chips(m) == want["chips"]
    assert [list(e) if isinstance(e, tuple) else e for e in leading_batch_spec(m, 2)] == want["lead"]


@pytest.mark.parametrize("key", SPECS)
def test_planner_from_spec_equals_reference(key, oracle):
    assert dryrun_fl.planner_from_spec(json.dumps(SPECS[key])) == oracle["planner"][key]


@pytest.mark.parametrize("key", BYTES_CASES)
def test_argument_and_output_bytes_equal_xla_memory_analysis(key, oracle):
    """Each position's bytes equal each device's in XLA's analysis, but for
    two things XLA holds that the port does not: the 8-byte entry an output
    buffer takes in the output tuple's table, and a decode cache's int32
    positions (the port keeps them on the host, as ints)."""
    arch, shape = BYTES_CASES[key]
    compiled = dryrun._compile(get_config(arch, reduced=True), InputShape(*shape),
                               make_meta_mesh((2, 4)), expert_parallel=False, lower_only=True)
    args, outs, n_outs, positions = oracle["bytes"][key]
    assert (positions == 8) == (key == "qwen3_decode")
    assert compiled.args == [args - positions] * 8
    assert compiled.outs == [outs - 8 * n_outs - positions] * 8
