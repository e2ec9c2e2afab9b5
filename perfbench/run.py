"""Run one cell of ``BENCHMARK.json`` once on the card; print one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the inputs from
the seed, the program's round, sampler and global model, and the checked
rounds, which build every kernel and warm every shape the window uses.
The window: whole rounds from a synchronised start until ``--seconds``
have passed, the round in flight finishing. ``--trace 1`` runs the same
window under ``torch.profiler`` and prints the per-layer metrics instead
of the end-to-end ones. Then, with the program's state freed, the plain
reference works the checked rounds out again and decides ``correct``
(:mod:`perfbench.check`); the numbers compared, each beside its limit,
end standard error and the result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
# every cache of a build or a compiler at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"

from perfbench import check, spec, work  # noqa: E402

#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (the loaded modules'),
    each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def readers(names) -> dict:
    out = {}
    for name in names:
        path = spec.HERE / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        if mod.NAME != name:
            raise ValueError(f"{path} declares {mod.NAME!r}")
        out[name] = mod
    return out


def leaf_diff_norms(fed, theta_0):
    """{leaf: ‖θ − θ⁰‖} over the port's parameters, by name."""
    import torch

    from perfbench.reference.lm import views

    mine = views(theta_0, fed.leaves)
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(p - mine[n], dtype=torch.float64))
                for n, p in fed.params.named_parameters()}


def setup_rounds(fed, seed: int, n_checked: int) -> dict:
    """The checked rounds, run through the window's own call before it."""
    from perfbench import generate

    out = {"records": [], "stores": [], "plans": []}
    for t in range(n_checked):
        rec = fed.round(t)
        out["records"].append(rec)
        if fed.feedback:
            out["stores"].append(fed.store_rows())
            out["plans"].append(fed.plan_tokens())
        theta_0 = generate.theta0(fed.leaves, seed, fed.device)
        norms = leaf_diff_norms(fed, theta_0)
        del theta_0
        out["first" if t == 0 else "change"] = norms
    return out


def window(fed, seconds: float, t0_round: int, traced: bool):
    from torch.profiler import profile, record_function

    from perfbench import trace
    from perfbench.driver import sync

    prof = profile(activities=trace.activities()) if traced else nullcontext()
    records = []
    with prof:
        sync(fed.device)
        start = time.perf_counter()
        t = t0_round
        while True:
            with record_function(trace.ROUND):
                records.append(fed.round(t))
            t += 1
            if time.perf_counter() - start >= seconds:
                break
        end = time.perf_counter()
    events = prof.profiler.kineto_results.events() if traced else None
    return records, end - start, events


def reference_numbers(cell, feedback: bool, setup, window_records, seed: int,
                      device) -> tuple[dict, dict]:
    """Work the checked rounds out again and compare; returns (numbers, info)."""
    import numpy as np

    from perfbench.reference import federated, sampling

    traffic, a = cell["traffic_file"], spec.arch(cell["config_file"])
    recs = setup["records"]
    rounds = [{"draws": r["draws"], "observed": list(range(r["n_observed"]))} for r in recs]
    signs = federated.signs_for(a, traffic, seed, device) if feedback else None
    ref = federated.run(a, traffic, seed, rounds, device=device, signs=signs)
    del signs
    names = ref["leaf_names"]
    first_ref, change_ref = ref["first_norms"].numpy(), ref["change_norms"].numpy()
    keep = check.kept_leaves(first_ref)
    numbers = {
        "loss_gap": check.loss_gap([r["loss"] for r in recs], ref["losses"]),
        "first_gap": check.leaf_gap([setup["first"][n] for n in names], first_ref, keep),
        "change_gap": check.leaf_gap([setup["change"][n] for n in names], change_ref, keep),
    }
    n_samples = np.full(traffic["n_clients"], traffic["client_samples"])
    m, M = traffic["m"], int(n_samples.sum())
    rng = np.random.default_rng(int(seed))
    drawn = [r["clients"] for r in recs + window_records]
    if feedback:
        sketches = [(r, c, row.numpy(), rms) for r, c, row, rms in ref["sketches"]]
        numbers["sketch_gap"] = check.sketch_gap(setup["stores"],
                                                 check.latest_rows(sketches, len(recs)))
        d_prime = traffic["planner"]["sketch_dim"]
        plans = [sampling.algorithm2_plan(np.zeros((traffic["n_clients"], d_prime)), n_samples, m)]
        plans += [sampling.algorithm2_plan(G, n_samples, m) for G in setup["stores"]]
        numbers["plan_mismatch"] = float(sum(int((p != q).sum())
                                             for p, q in zip(setup["plans"], plans[1:])))
        k = traffic["checked_draw_rounds"]
        want = [sampling.draw(p / M, rng) for p in plans[:k]]
    else:
        plan = sampling.md_plan(n_samples, m)
        want = [sampling.draw(plan, rng) for _ in drawn]
    numbers["draw_mismatch"] = float(sum(int((np.asarray(g) != w).sum()) for g, w in zip(drawn, want)))
    info = {"reference_s": ref["seconds"], "losses": [r["loss"] for r in recs],
            "losses_ref": ref["losses"], "leaves": len(names), "leaves_kept": int(keep.sum())}
    return numbers, info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from perfbench.driver import Federation

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    traffic = cell["traffic_file"]
    fed = Federation(cell["config_file"], traffic, args.seed, dev)
    setup = setup_rounds(fed, args.seed, traffic["checked_rounds"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries_0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    setup_s = time.perf_counter() - T_START
    records, window_s, events = window(fed, args.seconds, traffic["checked_rounds"], bool(args.trace))
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries_0
    n_rounds = len(records)
    tokens = n_rounds * fed.tokens_per_round
    failed = sum(1 for r in records if not np.isfinite(r["loss"]))
    if args.trace:
        from perfbench.trace import Trace

        tr = Trace(events)
        del events
        _, n_active = work.active_params([(n, s) for n, s, _ in fed.leaves])
        run = SimpleNamespace(trace=tr, rounds=records, arch=fed.arch, traffic=traffic, d=fed.d,
                              n_active=n_active, tokens_per_round=fed.tokens_per_round,
                              sketch_dim=traffic.get("planner", {}).get("sketch_dim") or 0,
                              counters={"alloc_retries": int(retries)})
        metrics = {}
        for name, mod in readers([m["name"] for m in cell["per_layer"]]).items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        busy = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        e2e = {
            "tokens_per_s": tokens / window_s,
            "sampling_ms": 1e3 * sum(r["sample_s"] + r["observe_s"] for r in records) / n_rounds,
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell["end_to_end"]}
        breakdown, busy = None, {}

    feedback = fed.feedback
    fed.close()
    del fed
    gc.collect()
    torch.cuda.empty_cache()
    numbers, info = reference_numbers(cell, feedback, setup, records, args.seed, dev)
    correct, checks = check.verdict(numbers, cell["limits"])
    correct &= failed == 0
    round_s = [r["round_s"] for r in records]
    print(f"perfbench: {args.workload} seed {args.seed}: {n_rounds} rounds in {window_s:.3f} s "
          f"(round s min {min(round_s):.4f} median {float(np.median(round_s)):.4f} max "
          f"{max(round_s):.4f}; {[round(x, 4) for x in round_s]}), setup {setup_s:.3f} s, reference {info['reference_s']:.3f} s, "
          f"losses {info['losses']} vs {info['losses_ref']}, leaves {info['leaves_kept']} of "
          f"{info['leaves']} compared, alloc retries {retries}, {torch.cuda.get_device_name(0)}",
          file=sys.stderr)
    for name in sorted(set(numbers) - set(checks)):
        print(f"reading {name} {numbers[name]!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(peak), **busy}
    result = {"correct": bool(correct), "attempted": n_rounds, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    found = forbidden_modules()  # after every import of the run: readers, reference, close
    if found:
        print(f"perfbench: the process loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
