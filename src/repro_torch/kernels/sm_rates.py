#!/usr/bin/env python3
"""Issue rates of one SM of the card: FFMA by warps a scheduler, and shared loads by pattern.

Compiles two microbenchmarks with nvcc into ``build/sm_rates_probe/`` and
prints, on the card the script runs on:

* FFMA: warp instructions an SM retires a ns with 1 to 16 warps an SM
  (1 to 4 a scheduler), each warp running 16 or 64 independent
  accumulators with operands in registers (peak: 4 a clock);
* shared loads: warp instructions an SM retires a ns for LDS.32 (32
  distinct banks, or one address) and LDS.128 (one address; 4 distinct
  16-byte addresses; 8 distinct addresses, each read by 4 lanes; 32
  distinct addresses), 16 warps an SM, each result added into a register.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python3 -m repro_torch.kernels.sm_rates
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]  # the repository
OUT = ROOT / "build" / "sm_rates_probe"

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>

template <int NACC>
__global__ void ffma(float* out, float x, float y, int iters) {
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = fmaf(acc[i], x, y);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = fmaf(acc[i], y, x);
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < NACC; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// P: 0 LDS.128 one address; 1 LDS.128 8 addresses (lane % 8); 2 LDS.128 32
// addresses; 3 LDS.32 32 banks; 4 LDS.32 one address; 5 LDS.128 4
// addresses (lane / 8) 144 bytes apart. The loads are asm volatile, so the
// compiler keeps every one of them in the loop.
template <int P>
__global__ void lds(float* out, int iters) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int off = P == 1 ? 4 * (lane % 8) : P == 2 ? 4 * lane : P == 3 ? lane : P == 5 ? 36 * (lane / 8) : 0;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(sm)) + 4 * off;
  float4 acc = make_float4(0, 0, 0, 0);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const unsigned addr = base + 4 * ((it & 7) * 512 + (P == 3 || P == 4 ? 32 : 128) * (u % 8));
      float4 v = make_float4(0, 0, 0, 0);
      if (P == 3 || P == 4)
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v.x) : "r"(addr));
      else
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

template <typename F>
float time_ms(F launch) {
  launch(10);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  launch(2000);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

template <int NACC>
void run_ffma(float* out, int sms, int warps_per_block, int blocks_per_sm) {
  const int blocks = sms * blocks_per_sm, threads = 32 * warps_per_block;
  const float ms = time_ms([&](int iters) { ffma<NACC><<<blocks, threads>>>(out, 0.999f, 0.001f, iters); });
  const double instrs = (double)blocks_per_sm * warps_per_block * 2000 * 2 * NACC;
  printf("ffma: %d accumulators, %d warps an SM: %.3f warp-FFMA an SM a ns\n", NACC,
         warps_per_block * blocks_per_sm, instrs / (ms * 1e6));
}

template <int P>
void run_lds(float* out, int sms, const char* name) {
  const float ms = time_ms([&](int iters) { lds<P><<<2 * sms, 256>>>(out, iters); });
  printf("lds: %-44s %.3f warp-loads an SM a ns\n", name, 16.0 * 2000 * 16 / (ms * 1e6));
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, sizeof(float) * sms * 4 * 1024);
  const int cfg[][2] = {{1, 1}, {2, 1}, {4, 1}, {8, 1}, {16, 1}, {3, 2}, {3, 3}};
  for (const auto& c : cfg) {
    run_ffma<16>(out, sms, c[0], c[1]);
    run_ffma<64>(out, sms, c[0], c[1]);
  }
  run_lds<3>(out, sms, "LDS.32, 32 banks");
  run_lds<4>(out, sms, "LDS.32, one address");
  run_lds<0>(out, sms, "LDS.128, one address");
  run_lds<5>(out, sms, "LDS.128, 4 addresses 144 bytes apart");
  run_lds<1>(out, sms, "LDS.128, 8 addresses (lane % 8)");
  run_lds<2>(out, sms, "LDS.128, 32 addresses");
  cudaFree(out);
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("sm_rates: needs nvcc", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "sm_rates.cu", OUT / "sm_rates"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe), str(src)],
                   check=True)
    subprocess.run([str(exe)], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
