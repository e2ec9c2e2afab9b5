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
// bytes, and at this size by the launch itself: an empty kernel on the same
// grid takes 0.7–0.9 µs of device time (PERF.md). What is left to win is
// latency: the rows must reach the SMs in as few round trips as possible.
//
// Design (measured against other plans and a TMA version on an H100 SXM:
// PERF.md, Findings):
// * A thread owns VEC = 2 columns; a block of `threads` owns 2·threads
//   consecutive columns. The plan (`launch_plan` in kernels/aggregate/ops.py)
//   depends on p alone: threads = ⌈⌈p / 2⌉ / 132⌉, so the grid is one
//   block on each SM of a 132-SM H100 and none waits for a second wave.
// * Rows are taken in passes of ROWS = 8, every load of a pass (and its 8
//   weights) issued before its first FMA, and the next pass's loads issued
//   before this pass's FMAs: up to 16 rows in flight. Longer passes, and a
//   second pass ahead, were slower: their code costs more at launch than
//   the round trips they save.
// * Fixed order: every output is fmaf(w[k-1], U[k-1, j], … fmaf(w[0],
//   U[0, j], 0)), rows ascending, whatever the pass, the layout or the
//   column's place in the grid. A call is bit-reproducible, and the same
//   values give the same bits in any layout.
// * Layout: where every row is 8-byte aligned (p even, U and out 8-byte
//   aligned) a thread's 2 columns are one 8-byte load a row and one store;
//   otherwise (an odd p, a view off alignment) the same grid takes 4-byte
//   loads, thread t of a block reading columns t and t + threads of its
//   block's span, so each warp load is 128 contiguous bytes.
// * Arithmetic is f32 FMA on the CUDA cores; no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // ops.MAX_THREADS
constexpr int VEC = 2;            // ops.VEC: columns a thread
constexpr int ROWS = 8;           // rows a pass

struct alignas(4 * VEC) Cols {
  float v[VEC];
};

// Issue the loads of rows [r0, r0 + ROWS) ∩ [0, k): `load(r)` gives the
// thread's columns of row r.
template <class Load>
__device__ __forceinline__ void load_pass(Cols (&u)[ROWS], float (&wr)[ROWS], Load load,
                                          const float* __restrict__ w, int r0, int k) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (r0 + i < k) u[i] = load(r0 + i);
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (r0 + i < k) wr[i] = __ldg(w + r0 + i);
}

__device__ __forceinline__ void add_pass(Cols& acc, const Cols (&u)[ROWS], const float (&wr)[ROWS],
                                         int r0, int k) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (r0 + i < k) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc.v[c] = fmaf(wr[i], u[i].v[c], acc.v[c]);
    }
}

// Σ_r w[r]·U[r, ·] over the thread's columns, rows ascending, one pass
// ahead.
template <class Load>
__device__ __forceinline__ Cols column_sums(Load load, const float* __restrict__ w, int k) {
  Cols acc;
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc.v[c] = 0.f;
  Cols a[ROWS], b[ROWS];
  float wa[ROWS], wb[ROWS];
  load_pass(a, wa, load, w, 0, k);
  for (int r0 = 0; r0 < k; r0 += 2 * ROWS) {
    load_pass(b, wb, load, w, r0 + ROWS, k);
    add_pass(acc, a, wa, r0, k);
    load_pass(a, wa, load, w, r0 + 2 * ROWS, k);
    add_pass(acc, b, wb, r0 + ROWS, k);
  }
  return acc;
}

// Rows 8-byte aligned: thread j owns columns 2j and 2j + 1.
__global__ void __launch_bounds__(MAX_THREADS)
aggregate_vec2(const Cols* __restrict__ U, const float* __restrict__ w, Cols* __restrict__ out,
               int k, int pv) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= pv) return;
  const Cols* col = U + j;
  out[j] = column_sums([&](int r) { return col[(size_t)r * pv]; }, w, k);
}

// Any layout: thread t of block b owns columns c0 = 2·T·b + t and c0 + T.
__global__ void __launch_bounds__(MAX_THREADS)
aggregate_scalar(const float* __restrict__ U, const float* __restrict__ w,
                 float* __restrict__ out, int k, int p) {
  const int T = blockDim.x;
  const int c0 = VEC * T * blockIdx.x + threadIdx.x, c1 = c0 + T;
  if (c0 >= p) return;
  const bool second = c1 < p;
  const Cols acc = column_sums(
      [&](int r) {
        const float* row = U + (size_t)r * p;
        Cols x;
        x.v[0] = __ldg(row + c0);
        x.v[1] = second ? __ldg(row + c1) : 0.f;
        return x;
      },
      w, k);
  out[c0] = acc.v[0];
  if (second) out[c1] = acc.v[1];
}

}  // namespace

// U (k, p) f32, w (k,) f32 -> out (p,) f32, all on the device, on the grid
// (blocks, threads) of ops.launch_plan. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int aggregate_rows(const float* U, const float* w, float* out, int k, int p, int blocks,
                              int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (p % VEC == 0) && (reinterpret_cast<uintptr_t>(U) % (4 * VEC) == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % (4 * VEC) == 0);
  if (aligned)
    aggregate_vec2<<<blocks, threads, 0, s>>>(reinterpret_cast<const Cols*>(U), w,
                                              reinterpret_cast<Cols*>(out), k, p / VEC);
  else
    aggregate_scalar<<<blocks, threads, 0, s>>>(U, w, out, k, p);
  return (int)cudaGetLastError();
}

// An empty kernel on a grid of `blocks` × `threads`: the launch floor a call
// of the same grid cannot go under (timed beside the kernel by chip_smoke.py).
__global__ void aggregate_empty() {}

extern "C" int aggregate_empty_launch(int blocks, int threads, void* stream) {
  aggregate_empty<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
