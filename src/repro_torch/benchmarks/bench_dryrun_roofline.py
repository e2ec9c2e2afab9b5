# Adapted from benchmarks/bench_dryrun_roofline.py: the same rows, read from
# the port's records.
"""Roofline summary benchmark: reads experiments/dryrun_torch/*.json (produced
by ``python -m repro_torch.launch.dryrun`` and ``launch.dryrun_fl``) and emits
one CSV row per (arch × shape × mesh × variant) with the three roofline terms:
counts priced by the H100 SXM data sheet's peaks, not measured times. Emits
``roofline/none`` when there are no records yet."""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.benchmarks.common import emit
from repro_torch.launch.dryrun import OUT_DIR


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="taken as every runner takes it; the records are counts, "
                         "so nothing runs on a device")
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.dir, "*.json")))
    if not files:
        emit("roofline/none", 0.0, "run `python -m repro_torch.launch.dryrun --all` first")
        return
    for f in files:
        with open(f) as fh:
            d = json.load(fh)
        tag = "+".join(d.get("variants") or []) or "baseline"
        if d.get("kind") == "fl_round":
            emit(
                f"roofline/{d['arch']}/{d['shape']}/{d['mesh']}/{tag}",
                d["t_collective_per_step"] * 1e6,
                f"coll_per_step={d['coll_bytes_per_chip_per_step'] / 2**20:.1f}MiB;"
                f"tx_per_step={d['t_collective_per_step'] * 1e3:.2f}ms",
            )
            continue
        emit(
            f"roofline/{d['arch']}/{d['shape']}/{d['mesh']}/{tag}",
            max(d["t_compute"], d["t_memory"], d["t_collective"]) * 1e6,
            f"tc={d['t_compute'] * 1e3:.2f}ms;tm={d['t_memory'] * 1e3:.2f}ms;"
            f"tx={d['t_collective'] * 1e3:.2f}ms;dom={d['dominant']};"
            f"util={d['utility_ratio']:.3f};hbm={d['hbm_per_chip_gb']}GB",
        )


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
