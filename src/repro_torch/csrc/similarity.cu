// Pairwise Gram (G Gᵀ) and L1 (Σ_k |G_ik − G_jk|) sums over the rows of G.
//
// Replaces the TPU kernels in src/repro/kernels/similarity/kernel.py:
// `pairwise_kernel` (bodies `_gram_kernel`, `_l1_kernel`) and
// `pairwise_kernel_fused` (body `_masked_fused_kernel`). Both compute the
// same function, because zero padding is exact for both ops, so here they
// are one kernel templated on the op that masks its own ragged edges.
//
// Input G is (n, d) f32, row-major and contiguous; the output is (n, n) f32.
// Arithmetic is full f32 with FMA on CUDA cores: no TF32, no tensor cores,
// because a plan is discrete and a TF32 error can flip a Ward merge.
//
// Bound on an H100 SXM at the main path's shape (n = 100, d = 39,760):
// G is 15.9 MB, about 4.7 µs at 3.35 TB/s; the i ≤ j half of the Gram is
// n(n+1)·d ≈ 0.40 GFLOP, about 6 µs at 67 TFLOP/s of f32 FMA. So the work is
// bounded by operations, and at n = 100 the real limit is too few output
// tiles: n = 100 gives 3 tiles with i ≤ j for 132 SMs.
//
// Design:
// * 64×64 output tiles, 256 threads, 4×4 outputs per thread in registers
//   (rows ty + 16·a, columns tx + 16·b, so shared-memory reads are free of
//   bank conflicts). (64 × 32)-slices of the two row blocks of G are staged
//   through shared memory with bounds-checked loads (zero outside n and d).
// * Only tiles with block-row ≤ block-column are computed; the reduce pass
//   mirrors them.
// * d is split across blocks to fill the card. Each split writes its partial
//   sums to a (splits, n, n) scratch; no float atomics. The second pass adds
//   the splits in a fixed order, so the result is bit-reproducible.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;

enum Op { GRAM = 0, L1 = 1 };

template <int OP>
__device__ __forceinline__ float accumulate(float acc, float a, float b) {
  if (OP == GRAM) return fmaf(a, b, acc);
  return acc + fabsf(a - b);
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
pairwise_partial(const float* __restrict__ G, float* __restrict__ partial,
                 int n, int d, int n_tiles, int chunks_per_split) {
  __shared__ float As[TILE][BK + 1];
  __shared__ float Bs[TILE][BK + 1];

  // tile pair p -> (bi, bj) with bi <= bj, enumerated row by row
  int p = blockIdx.x;
  int bi = 0;
  while (p >= n_tiles - bi) {
    p -= n_tiles - bi;
    ++bi;
  }
  const int bj = bi + p;
  const int i0 = bi * TILE;
  const int j0 = bj * TILE;
  const int split = blockIdx.y;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int n_chunks = (d + BK - 1) / BK;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  for (int c = c_begin; c < c_end; ++c) {
    const int k0 = c * BK;
    // 64 rows × 32 columns per block = 2048 values, 8 per thread; a warp
    // reads 32 consecutive columns of one row (one 128-byte line).
#pragma unroll
    for (int q = 0; q < (TILE * BK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK;
      const int k = e % BK;
      const int col = k0 + k;
      const bool col_ok = col < d;
      const int gi = i0 + r;
      const int gj = j0 + r;
      As[r][k] = (col_ok && gi < n) ? G[(size_t)gi * d + col] : 0.f;
      Bs[r][k] = (col_ok && gj < n) ? G[(size_t)gj * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[ty + 16 * a][k];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[tx + 16 * b][k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = accumulate<OP>(acc[a][b], av[a], bv[b]);
    }
    __syncthreads();
  }

  float* out = partial + (size_t)split * n * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = i0 + ty + 16 * a;
    if (r >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = j0 + tx + 16 * b;
      if (col < n) out[(size_t)r * n + col] = acc[a][b];
    }
  }
}

// out[r, c] = Σ_s partial[s, r', c'] in split order, where (r', c') is (r, c)
// if its tile lies on or above the tile diagonal, else the mirrored (c, r).
__global__ void pairwise_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                int n, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nn = (size_t)n * n;
  if (idx >= nn) return;
  const int r = (int)(idx / n);
  const int c = (int)(idx % n);
  const size_t src = (r / TILE <= c / TILE) ? idx : (size_t)c * n + r;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += partial[(size_t)q * nn + src];
  out[idx] = s;
}

}  // namespace

// G (n, d) f32 -> out (n, n) f32. `partial` is a (splits, n, n) f32 scratch
// the caller allocates; `op` is 0 for the Gram, 1 for L1. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int pairwise_sums(const float* G, float* partial, float* out, int n, int d,
                             int op, int splits, int chunks_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + TILE - 1) / TILE;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  dim3 grid(n_pairs, splits);
  if (op == GRAM) {
    pairwise_partial<GRAM><<<grid, THREADS, 0, s>>>(G, partial, n, d, n_tiles, chunks_per_split);
  } else if (op == L1) {
    pairwise_partial<L1><<<grid, THREADS, 0, s>>>(G, partial, n, d, n_tiles, chunks_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t nn = (size_t)n * n;
  const int rthreads = 256;
  const unsigned rblocks = (unsigned)((nn + rthreads - 1) / rthreads);
  pairwise_reduce<<<rblocks, rthreads, 0, s>>>(partial, out, n, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
