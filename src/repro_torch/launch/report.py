# Adapted from src/repro/launch/report.py: the same tables, read from the port's
# record directory.
"""Render the dry-run's tables from experiments/dryrun_torch/*.json.

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
Prints the §Dry-run and §Roofline markdown tables of the port's records
(``launch/dryrun.py``, ``launch/dryrun_fl.py``): counts priced by the H100
SXM data sheet's peaks (``launch/roofline.py``), not measured times.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_: str) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def roofline_table(recs: list[dict], *, mesh: str = "16x16", variants: str = "baseline") -> str:
    rows = [
        r
        for r in recs
        if r["mesh"] == mesh
        and not r.get("lower_only")
        and r.get("kind") != "fl_round"
        and ("+".join(r.get("variants") or []) or "baseline") == variants
    ]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    out = [
        "| arch | shape | t_compute | t_memory | t_collective | dominant | "
        "MODEL/HLO | HBM/chip | coll/chip |",
        "|---|---|---:|---:|---:|---|---:|---:|---:|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute'] * 1e3:.2f} ms "
            f"| {r['t_memory'] * 1e3:.2f} ms | {r['t_collective'] * 1e3:.2f} ms "
            f"| **{r['dominant']}** | {r['utility_ratio']:.2f} "
            f"| {r['hbm_per_chip_gb']:.2f} GiB "
            f"| {r['coll_bytes_per_chip'] / 2**30:.2f} GiB |"
        )
    return "\n".join(out)


def dryrun_table(recs: list[dict], *, variants: str = "baseline") -> str:
    rows = [
        r
        for r in recs
        if r.get("kind") != "fl_round"
        and ("+".join(r.get("variants") or []) or "baseline") == variants
    ]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9), r["mesh"]))
    out = [
        "| arch | shape | mesh | kind | params | active | flops/chip | "
        "bytes/chip | AR/AG/RS/A2A counts | compile |",
        "|---|---|---|---|---:|---:|---:|---:|---|---:|",
    ]
    for r in rows:
        cd = r["coll_detail"]
        counts = "/".join(
            str(cd[k]["count"])
            for k in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
        )
        kind = r["kind"] + (" (lower-only)" if r.get("lower_only") else "")
        flops = "—" if r.get("lower_only") else f"{r['flops_per_chip']:.2e}"
        byts = "—" if r.get("lower_only") else f"{r['bytes_per_chip']:.2e}"
        cnts = "—" if r.get("lower_only") else counts
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {kind} "
            f"| {r['n_params'] / 1e9:.2f}B | {r['n_params_active'] / 1e9:.2f}B "
            f"| {flops} | {byts} | {cnts} | {r['compile_s']:.0f}s |"
        )
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variants", default="baseline")
    args = ap.parse_args()
    recs = load(args.dir)
    print(f"# {len(recs)} dry-run records\n")
    print("## §Dry-run\n")
    print(dryrun_table(recs, variants=args.variants))
    print("\n## §Roofline\n")
    print(roofline_table(recs, mesh=args.mesh, variants=args.variants))


if __name__ == "__main__":
    main()
