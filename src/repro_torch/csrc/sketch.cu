// Signed random projection Y = X · S of the sketched gradient store.
//
// Replaces the TPU kernel `srp_sketch_kernel` (body `_srp_kernel`) in
// src/repro/kernels/sketch/kernel.py. S is a (d, d') matrix of ±1/√d' whose
// entry (k, j) is the low bit of murmur3's fmix32 over (k, j, seed); rows
// k ≥ d are zero. S is never stored: each block regenerates its tiles from
// the hash in shared memory.
//
// Input X is (c, d) f32, row-major and contiguous; the output is (c, d') f32.
// Arithmetic is f32 FMA on CUDA cores, no TF32: the sketched rows feed the
// similarity matrix, and a plan is discrete.
//
// Bound on an H100 SXM at the main path's shapes (d = 39,760, d' = 64):
// c = 10 is 25.4 M FMAs (50.9 MFLOP, 0.76 µs at 67 TFLOP/s) against 1.59 MB
// of X (0.47 µs at 3.35 TB/s); c = 64 is 4.86 µs against 3.04 µs. Both are
// bounded by operations. The hash is d · d' = 2.54 M fmix32 evaluations of
// about 10 integer operations each: it stays a small share only if each
// sign tile is made once and applied to all the rows it meets, so a block
// holds up to 64 rows of X against one tile.
//
// Design:
// * Grid (splits, column tiles of 64, row tiles of 64). A block owns a
//   contiguous range of d in (64 × 64) k-tiles. For each k-tile it builds
//   the (64 k × 64 j) sign tile in shared memory from the hash (uint32
//   arithmetic wraps like the reference's), stages the (64 rows × 64 k)
//   slice of X with coalesced, bounds-checked loads (no padded copy of X),
//   and every thread adds up to 16 rows × 1 column of products into
//   registers, skipping rows past c (the round has 10 of a tile's 64). X is
//   read from shared memory four k at a time (one 16-byte broadcast load),
//   the sum still taken k by k in order.
// * Each split writes its partial sums to a (splits, c, d') scratch; a
//   second pass adds the splits in a fixed order. No float atomics, so the
//   result is bit-reproducible.
// * The split count depends on d and d' only, never on c: a row's bits are
//   the same whatever other rows share the call, so the store does not
//   depend on how a round's rows were batched or deduplicated.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;   // k-tile: rows of S per shared-memory tile
constexpr int TJ = 64;   // columns of d' per block
constexpr int TR = 64;   // rows of X per block
constexpr int THREADS = 256;
constexpr int RPT = TR / (THREADS / TJ);  // rows per thread: 16

constexpr uint32_t C1 = 0x85EBCA6Bu;
constexpr uint32_t C2 = 0xC2B2AE35u;
constexpr uint32_t K_SALT = 0x9E3779B1u;
constexpr uint32_t J_SALT = 0x7FEB352Du;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= C1;
  h ^= h >> 13;
  h *= C2;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(THREADS)
srp_partial(const float* __restrict__ X, float* __restrict__ partial, int c, int d,
            int d_prime, uint32_t seed_term, float scale, int tiles_per_split) {
  __shared__ __align__(16) float Ss[TK][TJ];
  __shared__ __align__(16) float Xs[TR][TK];

  const int split = blockIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int r0 = blockIdx.z * TR;
  const int tid = threadIdx.x;
  const int tx = tid % TJ;  // column of the tile
  const int ty = tid / TJ;  // rows ty, ty + 4, ..., ty + 60 of the tile

  float acc[RPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a) acc[a] = 0.f;
  // rows of this thread that exist: ty + 4a < min(TR, c - r0); warp-uniform
  const int na = (min(TR, c - r0) - ty + 3) / 4;

  const int n_tiles = (d + TK - 1) / TK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * TK;
#pragma unroll
    for (int q = 0; q < (TK * TJ) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int kk = e / TJ;
      const int jj = e % TJ;
      const uint32_t k = (uint32_t)(k0 + kk);
      const uint32_t j = (uint32_t)(j0 + jj);
      const uint32_t h = mix32((k * K_SALT) ^ (j * J_SALT) ^ seed_term);
      const float s = (h & 1u) ? scale : -scale;
      Ss[kk][jj] = (k0 + kk < d) ? s : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (TR * TK) / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / TK;
      const int kk = e % TK;
      const int row = r0 + r;
      const int col = k0 + kk;
      Xs[r][kk] = (row < c && col < d) ? X[(size_t)row * d + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < TK; kk += 4) {
      const float s0 = Ss[kk][tx];
      const float s1 = Ss[kk + 1][tx];
      const float s2 = Ss[kk + 2][tx];
      const float s3 = Ss[kk + 3][tx];
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        if (a < na) {
          const float4 x = *reinterpret_cast<const float4*>(&Xs[ty + 4 * a][kk]);
          acc[a] = fmaf(x.x, s0, acc[a]);
          acc[a] = fmaf(x.y, s1, acc[a]);
          acc[a] = fmaf(x.z, s2, acc[a]);
          acc[a] = fmaf(x.w, s3, acc[a]);
        }
      }
    }
    __syncthreads();
  }

  const int col = j0 + tx;
  if (col >= d_prime) return;
  float* out = partial + (size_t)split * c * d_prime;
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int row = r0 + ty + 4 * a;
    if (row < c) out[(size_t)row * d_prime + col] = acc[a];
  }
}

// out[i] = Σ_s partial[s, i] in split order.
__global__ void srp_reduce(const float* __restrict__ partial, float* __restrict__ out,
                           size_t cd, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cd) return;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < splits; ++q) s += partial[(size_t)q * cd + idx];
  out[idx] = s;
}

}  // namespace

// X (c, d) f32 -> out (c, d_prime) f32. `partial` is a (splits, c, d_prime)
// f32 scratch the caller allocates. `seed_term` is (seed · 0x165667B1) mod
// 2^32 and `scale` is 1/√d' rounded to f32, both computed on the host as
// the reference does. Returns the cudaError_t of the launches (0 = success).
extern "C" int srp_sketch(const float* X, float* partial, float* out, int c, int d,
                          int d_prime, unsigned int seed_term, float scale, int splits,
                          int tiles_per_split, void* stream) {
  if (c < 1 || d < 1 || d_prime < 1 || splits < 1 || tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, (d_prime + TJ - 1) / TJ, (c + TR - 1) / TR);
  srp_partial<<<grid, THREADS, 0, s>>>(X, partial, c, d, d_prime, seed_term, scale,
                                       tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t cd = (size_t)c * d_prime;
  const int rthreads = 256;
  const unsigned rblocks = (unsigned)((cd + rthreads - 1) / rthreads);
  srp_reduce<<<rblocks, rthreads, 0, s>>>(partial, out, cd, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
