# Adapted from src/repro/launch/sweep.py, with --device.
"""Campaign launcher: one SweepSpec JSON → a resumable, collated RunStore.

The CLI face of :mod:`repro_torch.fl.sweep` — point it at a sweep JSON (inline
or a file) and a store directory; re-invoking the same pair resumes a
killed campaign (completed cells are skipped) and the collated CSVs come
out bit-identical to an uninterrupted run.

Usage:
  python -m repro_torch.launch.sweep sweep.json --store runs/fig2 [--workers 4]
  python -m repro_torch.launch.sweep sweep.json --store runs/fig2 --device cpu
  python -m repro_torch.launch.sweep sweep.json --list-cells
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.fl.sweep import SweepSpec, cell_group_label, run_sweep, write_collated


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sweep", help="SweepSpec JSON (inline or a file path)")
    ap.add_argument("--store", default=None,
                    help="RunStore directory (resumable; required unless --list-cells)")
    ap.add_argument("--workers", type=int, default=1, help="process-pool fan-out for independent cells")
    ap.add_argument("--no-collate", action="store_true", help="skip writing cells.csv / summary.csv")
    ap.add_argument("--list-cells", action="store_true", help="print the expanded grid and exit")
    ap.add_argument("--device", default="cuda",
                    help="device the cells run on (cuda, or cpu for the plain PyTorch versions)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    sweep = SweepSpec.from_arg(args.sweep)
    cells = sweep.cells()
    if args.list_cells:
        for c in cells:
            label = cell_group_label(c.overrides) or "base"
            print(f"{c.cell_id}  grid={c.grid_index} seed={c.seed_index}  {label}")
        print(f"# {len(cells)} cells = {len(cells) // sweep.n_seeds} grid points x {sweep.n_seeds} seeds")
        return
    if not args.store:
        ap.error("--store is required unless --list-cells")

    def on_cell(cell, status, summary, dt):
        label = cell_group_label(cell.overrides) or "base"
        extra = f" loss={summary['final_loss']:.4f}" if summary else ""
        print(f"[{status}] {cell.cell_id} seed={cell.seed_index} {label}"
              f"{extra} ({dt:.1f}s)", flush=True)

    store = run_sweep(
        sweep, args.store, workers=args.workers, on_cell=on_cell, device=args.device
    )
    if not args.no_collate:
        cells_csv, summary_csv = write_collated(store)
        print(f"# collated: {cells_csv}")
        print(f"# collated: {summary_csv}")


if __name__ == "__main__":
    main()
