"""Dry-run of the paper's round step: clustered-sampling FL at pod scale.

Port of ``src/repro/launch/dryrun_fl.py``. Counts ``make_fl_round_step``
(m clients × N local SGD steps × the eq. 3/4 combine through the aggregate
kernel, B2) over the production mesh of meta positions with
``launch.roofline.CostCounter``, as ``launch/dryrun.py`` counts the
synchronous steps, and records the same keys as the reference: m is the
mesh's data-parallel degree (one client a data group), each client's
batch ``global_batch // m`` sequences.

The port's round runs each client's N local steps one by one, so its
counts are exact: ``flops_per_chip_per_local_step`` is the busiest
position's count over the round divided by N (the combine's work
included, once). The reference divides nothing: XLA counts the body of
its scan over the local steps once. The round's inputs sit on the lead
position, as ``run_federated_lm`` hands them over (θ^t, the clients'
batches and weights), and are sent to each group from there; the
outputs are what the round leaves allocated at each position (the new θ
on the lead; with a planner, each group's rows of the (m, d) updates).

Usage:
  python -m repro_torch.launch.dryrun_fl --arch qwen3-0.6b --local-steps 8
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import OUT_DIR, apply_variants, count_step, mesh_name
from repro_torch.launch.fl_train import fl_input_specs, make_fl_round_step
from repro_torch.launch.mesh import data_parallel_degree, make_production_mesh, mesh_chips
from repro_torch.launch.steps import abstract_params


def run_fl_round(
    arch: str,
    *,
    n_local: int,
    multi_pod: bool = False,
    seq_len: int = 4096,
    global_batch: int = 256,
    out_dir: str = OUT_DIR,
    variants: "list[str] | None" = None,
    planner: str = "none",
):
    """Count one federated round of ``arch`` on the production mesh and
    write its record."""
    if planner not in ("none", "sync", "async"):
        raise ValueError(f"unknown planner {planner!r}; choose none | sync | async")
    t0 = time.time()
    cfg = apply_variants(get_config(arch), variants or [])
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    m = data_parallel_degree(mesh)  # one client per data group
    local_batch = global_batch // m

    # with a planner, the round also returns the (m, d) flat representative
    # gradients that feed Algorithm 2's store: count that variant
    with_updates = planner != "none"
    step_fn = make_fl_round_step(cfg, lr=1e-2, n_local_steps=n_local, with_updates=with_updates,
                                 mesh=mesh)
    specs = fl_input_specs(cfg, m, n_local, local_batch, seq_len)
    params = abstract_params(cfg)
    d_model_flat = sum(p.numel() for p in params.parameters())
    args = [sum(p.numel() * p.element_size() for p in params.parameters())
            + sum(t.numel() * t.element_size() for t in specs.values())] + [0] * (chips - 1)
    counts = count_step(
        lambda p, b: step_fn(p, b["client_tokens"], b["client_targets"], b["weights"]),
        (params, specs), chips, cfg, seq_len, "train")
    temp = [a - b for a, b in zip(counts["peak"], counts["end"])]
    hbm = [a + t + o for a, t, o in zip(args, temp, counts["end"])]
    busiest = max(range(chips), key=counts["moved"].__getitem__)
    total_coll = float(counts["moved"][busiest])
    colls = {k: {"count": int(v["count"][busiest]), "bytes": float(v["bytes"][busiest])}
             for k, v in counts["colls"].items()}
    rec = {
        "arch": arch,
        "shape": f"fl_round_N{n_local}",
        "mesh": mesh_name(mesh),
        "chips": chips,
        "kind": "fl_round",
        "m_clients": m,
        "n_local_steps": n_local,
        "flops_per_chip_per_local_step": float(max(counts["flops"])) / n_local,
        "coll_bytes_per_chip_per_round": total_coll,
        "coll_bytes_per_chip_per_step": total_coll / n_local,
        "coll_detail": colls,
        "t_collective_per_step": total_coll / n_local / rl.LINK_BW,
        "hbm_per_chip_gb": round(max(hbm) / 2**30, 3),
        # async keeps the rebuild off the round's critical path entirely; the
        # device-side cost of feeding it is the (m, d) f32 updates output
        "planner": planner,
        "planner_feed_bytes": (m * d_model_flat * 4) if with_updates else 0,
        "variants": variants or [],
        "compile_s": round(time.time() - t0, 1),
        "per_position": {"args": args, "temp": temp, "outs": counts["end"],
                         **{k: counts[k] for k in ("flops", "bytes", "moved", "kernels")}},
    }
    os.makedirs(out_dir, exist_ok=True)
    tag = "+".join(variants or []) or "baseline"
    if planner != "none":
        tag += f"+planner-{planner}"
    with open(
        os.path.join(out_dir, f"{arch}__fl_round_N{n_local}__{rec['mesh']}__{tag}.json"), "w"
    ) as f:
        json.dump(rec, f, indent=1)
    print(
        f"[OK] {arch} fl_round N={n_local} mesh={rec['mesh']} "
        f"coll/round={total_coll / 2**20:.1f}MiB coll/step={total_coll / n_local / 2**20:.1f}MiB "
        f"tx/step={rec['t_collective_per_step'] * 1e3:.2f}ms hbm={rec['hbm_per_chip_gb']}GB "
        f"({rec['compile_s']}s)",
        flush=True,
    )
    return rec


def planner_from_spec(spec_arg: str) -> str:
    """Derive the planner variant to count from an experiment-spec JSON.

    ``spec_arg`` is inline JSON or a path to a JSON file with (at least)
    ``sampler`` / ``planner`` sections (``repro_torch.fl.experiment``
    schema). A sampler that consumes representative gradients counts the
    planner-fed round in the spec's planner mode; plan-free samplers count
    the plain round (``"none"``).
    """
    from repro_torch.core.samplers import SAMPLERS
    from repro_torch.fl.experiment import PlannerSpec, SamplerSpec, load_spec_dict

    d = load_spec_dict(spec_arg)
    sampler = SamplerSpec.from_dict(d.get("sampler", {"name": "algorithm2", "m": 1}))
    planner = PlannerSpec.from_dict(d.get("planner", {}))
    consumes = getattr(SAMPLERS.get(sampler.name), "consumes_updates", False)
    return planner.mode if consumes else "none"


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument(
        "--planner", choices=("none", "sync", "async"), default="none",
        help="count the planner-fed round variant (returns the (m, d) flat "
        "representative gradients Algorithm 2's gradient store consumes)",
    )
    ap.add_argument(
        "--spec", default=None,
        help="experiment-spec JSON (inline or a file path); its sampler/"
        "planner sections pick the round variant to count (overrides --planner)",
    )
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    planner = planner_from_spec(args.spec) if args.spec else args.planner
    run_fl_round(
        args.arch, n_local=args.local_steps, multi_pod=args.multi_pod,
        out_dir=args.out, planner=planner,
    )


if __name__ == "__main__":
    main()
