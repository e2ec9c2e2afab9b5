// Weighted sum of stacked rows: out[p] = Σ_k w[k] · U[k, p].
//
// Replaces the TPU kernel `aggregate_kernel` (body `_agg_kernel`) in
// src/repro/kernels/aggregate/kernel.py: eq. 3/4 of the paper over the
// stacked flat client models. The engine appends θ^t as one extra row with
// weight `stale_weight`, which gives aggregate_stacked's `+ sw·θ` term
// without changing this function.
//
// Bound on an H100 SXM at the main path's shape (k = 11, p = 39,760): the
// kernel must read k·p·4 B ≈ 1.75 MB and write p·4 B ≈ 0.16 MB, about
// 0.57 µs at 3.35 TB/s; 2·k·p ≈ 0.87 MFLOP is negligible. It is bounded by
// bytes, and at this size by the launch itself.
//
// Design: each thread owns 4 consecutive columns and reads them as one
// float4 when the rows are 16-byte aligned (p % 4 == 0 and aligned base
// pointers), else one column with scalar loads. It walks k in a fixed
// order, so the result is bit-reproducible. Arithmetic is f32 FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
aggregate_vec4(const float4* __restrict__ U, const float* __restrict__ w,
               float4* __restrict__ out, int k, int p4) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < k; ++r) {
    const float wr = w[r];
    const float4 u = U[(size_t)r * p4 + j];
    acc.x = fmaf(wr, u.x, acc.x);
    acc.y = fmaf(wr, u.y, acc.y);
    acc.z = fmaf(wr, u.z, acc.z);
    acc.w = fmaf(wr, u.w, acc.w);
  }
  out[j] = acc;
}

__global__ void __launch_bounds__(THREADS)
aggregate_scalar(const float* __restrict__ U, const float* __restrict__ w,
                 float* __restrict__ out, int k, int p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  float acc = 0.f;
  for (int r = 0; r < k; ++r) acc = fmaf(w[r], U[(size_t)r * p + j], acc);
  out[j] = acc;
}

}  // namespace

// U (k, p) f32, w (k,) f32 -> out (p,) f32, all on the device. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int aggregate_rows(const float* U, const float* w, float* out, int k, int p,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (p % 4 == 0) && (reinterpret_cast<uintptr_t>(U) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    const int p4 = p / 4;
    aggregate_vec4<<<(p4 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(U), w, reinterpret_cast<float4*>(out), k, p4);
  } else {
    aggregate_scalar<<<(p + THREADS - 1) / THREADS, THREADS, 0, s>>>(U, w, out, k, p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
