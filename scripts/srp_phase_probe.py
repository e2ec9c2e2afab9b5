#!/usr/bin/env python3
"""Where a call of the SRP sketch kernels spends its time on the card, by phase.

The card's machine has no ``ncu``, so this script times the phases of the
partial pass from inside it. It copies ``src/repro_torch/csrc/sketch.cu``
into ``build/srp_probe/``, adds ``%globaltimer`` stamps to the partial pass
(in every block: when the copying half of the threads has issued its
copies, when the hashing half has hashed the signs, when the first k-tile
is ready for every thread, when the products are done, each from the
block's start), builds variants with nvcc, and prints for each the median
of every stamp over the blocks and the time a call takes with the queue
filled ahead
(partial and reduce pass, CUDA events over 50 calls), at the main path's
shapes (c = 10 and 64, d = 39,760, d' = 64). The variants tell the costs
apart; all but the first compute wrong sums and are only timed:

* ``as built``: the kernel as it is (its sums are checked against the plain
  version);
* ``no hash``: constant sign words in place of the hash;
* ``no sign select``: constant signs in the products;
* ``no X loads``: one load of X per row and k-tile, outside the k loop.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/srp_phase_probe.py

It fails, naming the text, if the kernel source no longer has a line it
patches.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "sketch.cu"
OUT = ROOT / "build" / "srp_probe"
SHAPES = [(10, 39760, 64), (64, 39760, 64)]
SEED = 7
# "memory" keeps the compiler from moving a stamp across the loads, stores
# and barriers around it
STAMP = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}) :: "memory");'
VARIANTS = {
    "as built": [],
    "no hash": ["-DPROBE_NO_HASH"],
    "no sign select": ["-DPROBE_NO_SELECT"],
    "no X loads": ["-DPROBE_NO_XLOAD"],
}


def patch(src: str) -> str:
    """The kernel source with stamps, a stamp buffer and the variants' switches."""
    edits = [
        ("            uint32_t seed_term, float scale, int per, int rows, int vec) {",
         "            uint32_t seed_term, float scale, int per, int rows, int vec,\n"
         "            unsigned long long* ts) {\n"
         "  unsigned long long t0, t1 = 0, t2 = 0, t3 = 0, t4;\n  " + STAMP.format("t0") + "\n"
         "  unsigned long long* p = ts + 5 * (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));"),
        ("      cp_async_commit();\n    }\n  } else {\n",
         "      cp_async_commit();\n    }\n    " + STAMP.format("t1") + "\n  } else {\n"),
        ("    hash_tiles(Sg, t_begin * TK, min(nt, STAGES), j0, seed_term, threadIdx.x - COPIERS,\n"
         "               THREADS - COPIERS);\n",
         "#ifdef PROBE_NO_HASH\n"
         "    for (int q = threadIdx.x - COPIERS; q < STAGES * WORDS * TJ; q += THREADS - COPIERS)\n"
         "      Sg[q] = 0x5a5a5a5au ^ q;\n#else\n"
         "    hash_tiles(Sg, t_begin * TK, min(nt, STAGES), j0, seed_term, threadIdx.x - COPIERS,\n"
         "               THREADS - COPIERS);\n#endif\n"
         "    " + STAMP.format("t2") + "\n    if (threadIdx.x == COPIERS && ts) p[2] = t2;\n"),
        ("    __syncthreads();              // for every thread, with its signs\n",
         "    __syncthreads();              // for every thread, with its signs\n"
         "    if (i == 0) " + STAMP.format("t3") + "\n"),
        ("  float* out = partial + (size_t)split * c * d_prime;",
         "  " + STAMP.format("t4") + "\n"
         "  if (threadIdx.x == 0 && ts) {\n"
         "    p[0] = t0; p[1] = t1 - t0; p[3] = t3 ? t3 - t0 : 0; p[4] = t4 - t0;\n  }\n"
         "  float* out = partial + (size_t)split * c * d_prime;"),
        ("        s[0][b] = (lo >> b) & 1u ? scale : -scale;\n"
         "        s[1][b] = (hi >> b) & 1u ? scale : -scale;",
         "#ifdef PROBE_NO_SELECT\n        s[0][b] = (b & 1) ? scale : -scale;\n"
         "        s[1][b] = (b & 2) ? scale : -scale;\n#else\n"
         "        s[0][b] = (lo >> b) & 1u ? scale : -scale;\n"
         "        s[1][b] = (hi >> b) & 1u ? scale : -scale;\n#endif"),
        ("        const float4 x = *reinterpret_cast<const float4*>(xs + (warp + WARPS * a) * TK + w * 32 + kk);",
         "#ifdef PROBE_NO_XLOAD\n"
         "        const float4 x = *reinterpret_cast<const float4*>(xs + (warp + WARPS * a) * TK);\n#else\n"
         "        const float4 x = *reinterpret_cast<const float4*>(xs + (warp + WARPS * a) * TK + w * 32 + kk);\n"
         "#endif"),
        ("int splits, int per, void* stream) {",
         "int splits, int per, void* stream,\n                          unsigned long long* ts) {"),
        ("(X, partial, c, d, d_prime, seed_term, scale, per, rows, vec);",
         "(X, partial, c, d, d_prime, seed_term, scale, per, rows, vec, ts);"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"srp_phase_probe: {SRC.name} no longer has exactly one {old.strip()!r}")
        src = src.replace(old, new)
    return src


def build() -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "sketch_probe.cu"
    cu.write_text(patch(SRC.read_text()))
    nvcc = "/usr/local/cuda/bin/nvcc"
    procs = {}
    for i, (name, flags) in enumerate(VARIANTS.items()):
        lib = OUT / f"libprobe{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", *flags, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"srp_phase_probe: nvcc failed for {name!r}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].srp_sketch.restype = ctypes.c_int
        libs[name].srp_sketch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_uint32, ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("srp_phase_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.sketch import ops as sk_ops
    from repro_torch.kernels.sketch.ref import seed_term, sketch_srp_plain, srp_scale

    libs = build()
    gen = torch.Generator().manual_seed(0)
    print(f"srp_phase_probe: {torch.cuda.get_device_name(0)}")
    for c, d, dp in SHAPES:
        X = (1e-3 * torch.randn((c, d), generator=gen)).cuda()
        splits, per = sk_ops.split_plan(d)
        partial = torch.empty((splits, c, dp), device="cuda")
        out = torch.empty((c, dp), device="cuda")
        ts = torch.zeros(splits * 5, dtype=torch.int64, device="cuda")
        want = sketch_srp_plain(X, dp, SEED)
        for name, lib in libs.items():
            def call(stamps=0):
                err = lib.srp_sketch(X.data_ptr(), partial.data_ptr(), out.data_ptr(), c, d, dp,
                                     seed_term(SEED), srp_scale(dp), splits, per,
                                     torch.cuda.current_stream().cuda_stream, stamps)
                if err:
                    raise RuntimeError(f"srp_phase_probe: CUDA error {err}")

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            torch.cuda._sleep(10_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            us = start.elapsed_time(end) / 50 * 1e3
            call(ts.data_ptr())
            torch.cuda.synchronize()
            rows = ts.view(splits, 5).cpu().tolist()
            working = [r for r in rows if r[3]]  # blocks with a k-tile
            for r in working:  # the hashing thread's stamp is absolute; thread 0's t0 is the start
                r[2] -= r[0]
            med = [statistics.median(r[i] for r in working) for i in (1, 2, 3, 4)]
            first = min(r[0] for r in rows)
            last = max(r[0] + r[4] for r in rows)
            check = ""
            if name == "as built":
                check = f"; max |got - plain| {float((out - want).abs().max()):.3e}"
            print(f"srp_phase_probe: c = {c} {name}: {us:.2f} us a call (queue filled); partial pass "
                  f"{last - first} ns first start to last end; median ns from a block's start: "
                  f"copies issued {med[0]:.0f}, signs hashed {med[1]:.0f}, first k-tile ready "
                  f"{med[2]:.0f}, products done {med[3]:.0f}{check}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
