#!/usr/bin/env python3
"""Kernel B4 built from this source and from another, in turns on the card.

Compiles ``csrc/flash_attention.cu`` and another source with the same C
interface (``--other``, for example an earlier commit's
``src/repro_torch/csrc/flash_attention.cu`` unpacked under ``build/``) into
``build/flash_turns/``, both ``nvcc`` at once, and prints each one's build
seconds and ptxas register and spill lines. Then, at the serve paths' bf16
shapes (``chip_smoke.py``'s FLASH_PATH, FLASH_MOE and FLASH_WHISPER), it
checks that the two give the same output bit for bit and times them in
turns (other, this, this, other): CUDA events over 20 calls as called, and
with the queue filled ahead.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python3 -m repro_torch.kernels.flash_attention.turns \\
        --other build/parent/src/repro_torch/csrc/flash_attention.cu
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]  # the repository
OUT = ROOT / "build" / "flash_turns"


def _build_both(sources: dict) -> dict:
    """{label: loaded library}, compiling every source at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{label}.so"),
                                      str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
             for label, src in sources.items()}
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    libs = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {sources[label]}:\n{log}")
        print(f"turns: {label} ({sources[label]}) built by {time.perf_counter() - t0:.3f} s")
        for fn, line in smoke.ptxas_report(log):
            print(f"  ptxas {label} {fn}: {line}")
        libs[label] = ctypes.CDLL(str(OUT / f"lib{label}.so"))
    return libs


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, help="a flash_attention.cu with the same C interface")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash turns: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    libs = _build_both({"other": Path(args.other).resolve(), "this": _build.CSRC / "flash_attention.cu"})
    for lib in libs.values():
        ops.bind(lib)
    import chip_smoke as smoke

    gen = torch.Generator().manual_seed(0)
    name = torch.cuda.get_device_name(0)
    for shape in (smoke.FLASH_PATH, smoke.FLASH_MOE, smoke.FLASH_WHISPER):
        b, s, h, kv, hd = shape
        q, k, v = (torch.randn(dims, generator=gen).to("cuda", torch.bfloat16)
                   for dims in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        outs = {label: ops.launch(lib, q, k, v, True) for label, lib in libs.items()}
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        called = {label: [] for label in libs}
        queued = {label: [] for label in libs}
        for label in ("other", "this", "this", "other"):
            fn = lambda lib=libs[label]: ops.launch(lib, q, k, v, True)
            called[label].append(smoke.time_ms(torch, fn, reps=20))
            queued[label].append(smoke.time_ms(torch, fn, reps=20, queued=True))
        print(f"turns: bf16 {shape} on {name}: outputs bit-equal {same}; ms a call in turns "
              f"(other, this, this, other) as called {called['other'][0]:.6f}, "
              f"{called['this'][0]:.6f}, {called['this'][1]:.6f}, {called['other'][1]:.6f}; "
              f"queued {queued['other'][0]:.6f}, {queued['this'][0]:.6f}, "
              f"{queued['this'][1]:.6f}, {queued['other'][1]:.6f}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
