#!/usr/bin/env python3
"""Variants of the similarity kernel, side by side on the card.

Builds ``src/repro_torch/csrc/similarity.cu`` as it is and variants of it
that change one knob each (the ring's depth, the lane tile's columns, the
unrolling of the k loop, the loads of the next step in flight during a
step's products, the reduce pass's warps and launch, the tile of
one-split calls)
into ``build/similarity_variants/``, prints each build's ptxas report,
and, for each variant, each split plan (chunks a split in ``PERS``
beside ``ops.split_plan``'s) and each lane tile (the split calls' 8 × 4 and
the one-split calls' 4 × 4), checks
the sums at the main path's shapes against the plain version (Gram:
|got − want| ≤ 1e-5·‖g_i‖·‖g_j‖; L1: atol 1e-4; symmetric bit for bit) and
prints the ms a call takes with the queue filled ahead (CUDA events over 50
calls) and the device-busy ms a call (torch.profiler over 20). The split
plan and the lane tile are arguments of the C entry point, so every plan
is timed through the same build. The ``stamped`` variant adds
``%globaltimer`` stamps to the partial pass and prints, per call, the
median over the blocks of when thread 0 has issued its first copies, has
its first chunk, has done its products and has stored its sums, each from
its block's start (the card's machine has no ``ncu``).

Run from the repository root on a machine with an NVIDIA GPU and nvcc
(it reads ``chip_smoke.py``'s checks and timers from the root):

    PYTHONPATH=src python3 -m repro_torch.kernels.similarity.variants

It fails, naming the text, if the kernel source no longer has a line it
patches.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[4]  # the repository
SRC = ROOT / "src" / "repro_torch" / "csrc" / "similarity.cu"
OUT = ROOT / "build" / "similarity_variants"
SHAPES = [((100, 39760), "gram"), ((100, 39760), "l1"), ((100, 64), "gram")]
STAGES = "constexpr int STAGES = 3;"
SMALL = "constexpr int SMALL_GROUPS = 4;"
COLS = "constexpr int COL_TILE = 4;"
LOOP = "#pragma unroll\n  for (int kk = 0; kk < BK; kk += 4) {"
# the next step's loads in flight during this step's products, both ops
DOUBLE = """  float4 x0[TR], y0[TC], x1[TR], y1[TC];
  load_step<TR, TC>(x0, y0, as, bs, 0);
#pragma unroll 1
  for (int kk = 0; kk < BK; kk += 8) {
    load_step<TR, TC>(x1, y1, as, bs, kk + 4);
    step_products<OP, TR, TC>(acc, x0, y0);
    if (kk + 8 < BK) load_step<TR, TC>(x0, y0, as, bs, kk + 8);
    step_products<OP, TR, TC>(acc, x1, y1);
  }
  return;
"""
REDUCE = "constexpr int REDUCE_WARPS = 16;"
PDL = "  cfg.numAttrs = 1;"
WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partial pass has finished\n'

# "memory" keeps the compiler from moving a stamp across the loads, stores
# and barriers around it
STAMP = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"({}) :: "memory");'
# %globaltimer stamps of thread 0 of each block, from the block's start:
# prologue copies issued, first chunk ready, products done, sums stored
STAMPED = [
    ('  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n',
     '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n'
     '  unsigned long long t0, t1, t2 = 0, t3, t4;\n  ' + STAMP.format("t0") + "\n"),
    ("  float acc[TR][TC];\n",
     "  " + STAMP.format("t1") + "\n  float acc[TR][TC];\n"),
    ("    cp_async_commit();\n    const float* st = smem + (i % STAGES) * stage_floats;\n",
     "    cp_async_commit();\n    if (i == 0) " + STAMP.format("t2") + "\n"
     "    const float* st = smem + (i % STAGES) * stage_floats;\n"),
    ("  if (gridDim.y > 1) {\n    if (ac.x < 0) return;",
     "  " + STAMP.format("t3") + "\n"
     "  struct Stamp {\n    unsigned long long* p; unsigned long long t0, t1, t2, t3; int on;\n"
     "    __device__ ~Stamp() {\n      unsigned long long t4;\n      " + STAMP.format("t4") + "\n"
     "      if (on) { p[0] = t1 - t0; p[1] = t2 ? t2 - t0 : 0; p[2] = t3 - t0; p[3] = t4 - t0; }\n    }\n"
     "  } stamp{g_stamps + 4 * (blockIdx.x + gridDim.x * blockIdx.y), t0, t1, t2, t3,\n"
     "          threadIdx.x == 0 && blockIdx.x + gridDim.x * blockIdx.y < MAX_STAMPED};\n"
     "  if (gridDim.y > 1) {\n    if (ac.x < 0) return;"),
    ("template <int OP, int TR, int TC, int TG>\n__global__ void __launch_bounds__(MAX_THREADS)\n",
     "constexpr int MAX_STAMPED = 4096;\n__device__ unsigned long long g_stamps[4 * MAX_STAMPED];\n"
     "template <int OP, int TR, int TC, int TG>\n__global__ void __launch_bounds__(MAX_THREADS)\n"),
    ('extern "C" long long pairwise_scratch_floats(',
     'extern "C" int read_stamps(unsigned long long* host, int blocks) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, g_stamps, 4 * sizeof(unsigned long long) *\n'
     '                                   (blocks < MAX_STAMPED ? blocks : MAX_STAMPED));\n}\n\n'
     'extern "C" long long pairwise_scratch_floats('),
]
VARIANTS = {
    "as built": [],
    "stamped": STAMPED,
    "4 stages": [(STAGES, STAGES.replace("3", "4"))],
    "8 × 8 lane tiles": [(COLS, COLS.replace("4", "8"))],
    "k loop rolled": [(LOOP, LOOP.replace("unroll", "unroll 1"))],
    "loads a step ahead": [("  float4 x[TR], y[TC];\n#pragma unroll\n",
                            DOUBLE + "  float4 x[TR], y[TC];\n#pragma unroll\n")],
    # one group a warp of the reduce pass at 249 splits
    "reduce 32 warps a block": [(REDUCE, REDUCE.replace("16", "32"))],
    # the reduce pass as a plain launch after the partial pass
    "reduce without PDL": [(PDL, "  cfg.numAttrs = 0;")],
    # only timed (wrong sums): the reduce pass waits for the partial pass,
    # then stops; its time over the partial pass's is the launch's own
    "reduce returns after its wait": [(WAIT, WAIT + "  if (splits > 0) return;\n")],
    # one-split calls in tiles as large as the split calls'
    "4 × 4 tiles of 16 groups": [(SMALL, SMALL.replace("4", "16"))],
}
TIMED_ONLY = {"reduce returns after its wait"}
PERS = (3, 4, 5, 8, 15)  # chunks a split, beside ops.split_plan's


def build(name: str, edits) -> tuple[Path, subprocess.Popen, int]:
    """Write the variant's source and start nvcc on it; returns (library,
    process, columns of a split call's lane tile)."""
    src = SRC.read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{SRC.name} no longer has {old!r}")
        src = src.replace(old, new)
    slug = name.replace(" ", "_").replace(",", "").replace("(", "").replace(")", "")
    cu, lib = OUT / f"{slug}.cu", OUT / f"lib{slug}.so"
    cu.write_text(src)
    from repro_torch.kernels import _build

    cols = int(re.search(r"COL_TILE = (\d+);", src).group(1))
    return lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), cols


def plans_for(n: int, d: int) -> list[tuple[int, int]]:
    """(splits, per): ops.split_plan's, and one a value of PERS that d allows."""
    from repro_torch.kernels.similarity import ops

    n_chunks = -(-d // ops.BK)
    plans = {ops.split_plan(n, d)}
    plans |= {(-(-n_chunks // per), per) for per in PERS if per < n_chunks}
    return sorted(plans)


def print_stamps(lib, torch, call, splits, ts, n):
    """Medians over the blocks of one call, µs from each block's start."""
    import statistics

    call()
    torch.cuda.synchronize()
    small = int(re.search(r"SMALL_GROUPS = (\d+);", SRC.read_text()).group(1))
    groups = -(-n // ts)
    n_tiles = -(-groups // (16 if ts == 8 else small))
    blocks = n_tiles * (n_tiles + 1) // 2 * splits
    buf = (ctypes.c_ulonglong * (4 * min(blocks, 4096)))()
    lib.read_stamps.restype = ctypes.c_int
    if lib.read_stamps(buf, blocks):
        raise RuntimeError("read_stamps failed")
    cols = [[buf[4 * b + k] / 1e3 for b in range(min(blocks, 4096))] for k in range(4)]
    names = ("copies issued", "first chunk ready", "products done", "sums stored")
    print("    stamps (median µs from the block's start): " + ", ".join(
        f"{nm} {statistics.median(c):.3f}" for nm, c in zip(names, cols))
        + f"; max sums stored {max(cols[3]):.3f}")


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels.similarity.ref import gram_ref, l1_ref

    if not torch.cuda.is_available():
        print("similarity_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    libs, cols = {}, {}
    for name, (lib, proc, cols[name]) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        for fn, line in smoke.ptxas_report(log):
            if fn.startswith("pairwise_"):
                print(f"ptxas [{name}] {fn}: {line}")
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].pairwise_sums.restype = ctypes.c_int
        libs[name].pairwise_sums.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        libs[name].pairwise_scratch_floats.restype = ctypes.c_longlong
        libs[name].pairwise_scratch_floats.argtypes = [ctypes.c_int] * 2

    gen = torch.Generator().manual_seed(0)
    for (n, d), op in SHAPES:
        G = (smoke.SIM_SCALE * torch.randn((n, d), generator=gen)).cuda()
        want = gram_ref(G) if op == "gram" else l1_ref(G)
        for name, lib in libs.items():
            for (splits, per), ts in ((plan, ts) for plan in plans_for(n, d) for ts in (8, 4)):
                out = torch.empty((n, n), device="cuda")
                part = torch.empty((splits, lib.pairwise_scratch_floats(n, ts)), device="cuda")

                def call():
                    err = lib.pairwise_sums(G.data_ptr(), part.data_ptr(), out.data_ptr(), n, d,
                                            0 if op == "gram" else 1, splits, per, ts,
                                            torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                if op == "gram":
                    e = smoke.gram_rel_err(out, want, G)
                    ok = e <= smoke.GRAM_RTOL
                else:
                    e = float((out - want).abs().max())
                    ok = e <= smoke.SIM_ATOL
                if name not in TIMED_ONLY and (not ok or not torch.equal(out, out.T)):
                    raise SystemExit(f"{name} {op} ({n}, {d}) plan {splits} × {per}, lane tile {ts}: error {e}")
                queued = smoke.time_ms(torch, call, queued=True)
                busy = smoke.device_ms(torch, call)
                tile = f"{ts} × {cols[name] if ts == 8 else ts}"
                print(f"[{name}] {op} ({n}, {d}) {splits} splits of {per} chunks, {tile} a lane: queued "
                      f"{queued:.6f} ms a call, device-busy {busy:.6f} ms, error {e:.3e}")
                if name == "stamped":
                    print_stamps(lib, torch, call, splits, ts, n)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
