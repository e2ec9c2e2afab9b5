#!/usr/bin/env python3
"""The aggregate kernel's grids side by side on the card.

Builds the kernels and runs ``chip_smoke.py``'s aggregate checks
(``phase_kernels_agg``: the plain version at its shapes, bit-reproducible,
bit-equal across layouts, one device kernel a call). Then, at (11, 39,760)
and (41, 39,760), for the plan's block size and 64, 96, 128 and 256
threads a block (blocks to cover p), it checks the sums against the plain
version (rtol = atol 2e-5, and bit-equal to the wrapper's) and prints the
ms a call with the queue filled ahead (CUDA events over 50 calls), the
device-busy ms a call (torch.profiler over 20) and an empty kernel's on the
same grid. Then the wrapper and ``torch.mv(U.T, w)`` device-busy over
k = 1 to 300 at p = 39,760. Last, ``agg_turns``: the wrapper and
``torch.mv`` in turns, the launch floor and the wrapper's host µs step by
step.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python3 -m repro_torch.kernels.aggregate.variants

(Earlier commits of this file swept other plans: 1, 2 or 4 columns a
thread, 4 to 32 rows a pass, with and without the next pass ahead, and a
TMA version; PERF.md names them.)
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]  # the repository
THREADS = (64, 96, 128, 256)  # block sizes beside the plan's


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels.aggregate import ops
    from repro_torch.kernels.aggregate.ref import aggregate_ref

    if not torch.cuda.is_available():
        print("aggregate variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gen = torch.Generator().manual_seed(0)
    smoke.phase_build()
    smoke.phase_kernels_agg(torch, gen)
    lib = ops._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for k, p in smoke.AGG_SHAPES[:2]:
        U = torch.randn((k, p), generator=gen).cuda()
        w = torch.rand((k,), generator=gen).cuda()
        want, kept = aggregate_ref(U, w), ops.aggregate_flat(U, w)
        _, planned = ops.launch_plan(k, p)
        for threads in (planned, *THREADS):
            blocks = -(-(-(-p // ops.VEC)) // threads)

            def floor():
                lib.aggregate_empty_launch(blocks, threads, stream)

            out = torch.empty(p, device="cuda")

            def call():
                err = lib.aggregate_rows(U.data_ptr(), w.data_ptr(), out.data_ptr(), k, p, blocks,
                                         threads, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            call()
            torch.cuda.synchronize()
            e = float((out - want).abs().max())
            label = f"({k}, {p}) {blocks} × {threads}"
            if not torch.allclose(out, want, rtol=smoke.AGG_TOL, atol=smoke.AGG_TOL):
                raise SystemExit(f"{label}: error {e}")
            if not torch.equal(out, kept):
                raise SystemExit(f"{label}: other bits than the wrapper's")
            print(f"[grid] {label}: queued {smoke.time_ms(torch, call, queued=True):.6f} ms a call, "
                  f"device-busy {smoke._ms(smoke.device_ms(torch, call))}; empty kernel "
                  f"{smoke.time_ms(torch, floor, queued=True):.6f}, "
                  f"{smoke._ms(smoke.device_ms(torch, floor))}")
    p = smoke.AGG_SHAPE[1]
    for k in (1, 4, 8, 11, 16, 24, 32, 41, 64, 128, 300):
        U = torch.randn((k, p), generator=gen).cuda()
        w = torch.rand((k,), generator=gen).cuda()
        print(f"[k sweep] ({k}, {p}) plan {ops.launch_plan(k, p)}: device-busy kernel "
              f"{smoke._ms(smoke.device_ms(torch, lambda: ops.aggregate_flat(U, w)))}, torch.mv "
              f"{smoke._ms(smoke.device_ms(torch, lambda: torch.mv(U.T, w)))}")
    smoke.agg_turns(torch, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
