// Signed random projection Y = X · S of the sketched gradient store.
//
// Replaces the TPU kernel `srp_sketch_kernel` (body `_srp_kernel`) in
// src/repro/kernels/sketch/kernel.py. S is a (d, d') matrix of ±1/√d' whose
// entry (k, j) is the low bit of murmur3's fmix32 over (k, j, seed); rows
// k ≥ d are zero. S is never stored: each block hashes its own signs.
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
// sign is hashed once and applied to every row it meets, so a block holds
// up to 64 rows of X against one column tile.
//
// Design:
// * Grid (splits, column tiles of 64, row tiles of 64). Split s owns k-tiles
//   [s·per, (s+1)·per) of 64 columns of d; a split past the end writes
//   zeros. The plan (`split_plan` in kernels/sketch/ops.py) depends on d
//   only, never on c: a row's bits are the same whatever other rows share
//   the call.
// * At its start a block puts its whole X slice in flight with `cp.async`
//   (rows < c only; 16 B a thread when d % 4 == 0 and X is 16-byte aligned,
//   else 4 B; columns ≥ d zero-filled) into a ring of STAGES k-tiles of
//   dynamic shared memory. At the main path's shapes (5 k-tiles a split)
//   the whole slice is requested before the first product; at larger d the
//   ring recycles, one stage per k-tile consumed.
// * Half the block's threads issue those copies while the other half hash
//   the signs of its k-tiles as bits: one 32-bit word per (column, 32
//   consecutive k), each half-word built by one thread from 16 independent
//   hashes that overlap, with no ballot across lanes.
// * Products: lane l of warp w owns columns l and l + 32 and rows w, w + 8,
//   …, w + 56 of the tile, skipping rows past c. It reads its columns' sign
//   words once per 32 k and X four k at a time (one 16-byte broadcast load
//   that feeds eight FMAs); the sum is taken k by k in ascending order,
//   acc = fmaf(x, ±scale, acc).
// * Each split writes its partial sums to a (splits, c, d') scratch, and a
//   second kernel adds them in a fixed order: each group of GROUP splits in
//   split order, then the group sums in group order,
//   ((p₀ + … + p₇) + (p₈ + … + p₁₅)) + …. A block of the second kernel takes
//   32 outputs; warp g loads its group's GROUP partials at once, so the
//   whole sum costs one round trip to L2. It is launched as a programmatic
//   dependent of the first (it may be scheduled as the first starts, and
//   `griddepcontrol.wait` holds it until the partials are written), which
//   hides most of a launch's gap. No float atomics, so the result is
//   bit-reproducible.
// * Why two kernels: the same order in one launch, with each group a
//   thread-block cluster reduced through distributed shared memory and the
//   last cluster (by ticket) adding the group sums, was built and measured
//   on an H100 SXM (PERF.md, Findings): the card holds 15 clusters of 8 with
//   one block an SM, so the 16th shares SMs with another and doubles the
//   launch's time (0.021 ms at c = 10 and 0.037 at c = 64), and its
//   epilogue of cluster barriers, fences and a ticket costs about what the
//   second launch does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 64;   // k-tile: columns of d per ring stage
constexpr int TJ = 64;   // columns of d' per block
constexpr int TR = 64;   // rows of X per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = TR / WARPS;           // rows per warp: 8
constexpr int COPIERS = THREADS / 2;      // threads that issue a block's first copies
constexpr int STAGES = 5;                 // k-tiles in flight: a split's whole slice at d = 39,760
constexpr int WORDS = TK / 32;            // sign words per column per k-tile
constexpr int GROUP = 8;                  // splits the reduction adds in order first
constexpr int MAX_GROUPS = 16;            // 128 splits at most
constexpr int MAX_DEVICES = 64;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 0) of global memory into 16 shared bytes, zero-filling the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` (4 or 0) of global memory into 4 shared bytes, zero-filling the rest.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Request rows [r0, r0 + nr) × columns [k0, k0 + TK) of X into the stage
// `xs` (nr rows of TK floats), spread over threads tid, tid + nth, ….
// Columns ≥ d arrive as zeros.
__device__ __forceinline__ void issue_tile(float* xs, const float* __restrict__ X, int r0, int nr,
                                           int d, int k0, bool vec, int tid, int nth) {
  if (vec) {  // d % 4 == 0: a 4-column chunk lies wholly inside or outside d
    for (int e = tid; e < nr * (TK / 4); e += nth) {
      const int r = e / (TK / 4);
      const int col = k0 + 4 * (e % (TK / 4));
      const bool in = col < d;
      cp_async16(xs + r * TK + (col - k0), in ? X + (size_t)(r0 + r) * d + col : X, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < nr * TK; e += nth) {
      const int r = e / TK;
      const int col = k0 + e % TK;
      const bool in = col < d;
      cp_async4(xs + r * TK + (col - k0), in ? X + (size_t)(r0 + r) * d + col : X, in ? 4 : 0);
    }
  }
}

// Sign bits of k-tiles k0, k0 + TK, …, n_tiles of them, for columns
// j0 .. j0 + TJ: word (t · WORDS + w) · TJ + jj holds bit b = 1 where
// S[k0 + t·TK + 32w + b, j0 + jj] = +scale. Thread tid (of nth) hashes
// the 16 consecutive k of half-words tid, tid + nth, … and stores each
// whole; the 16 hashes are independent, so they overlap.
__device__ __forceinline__ void hash_tiles(uint32_t* sg, int k0, int n_tiles, int j0,
                                           uint32_t seed_term, int tid, int nth) {
  uint16_t* half = reinterpret_cast<uint16_t*>(sg);
  for (int hw = tid; hw < n_tiles * WORDS * TJ * 2; hw += nth) {
    const int wd = hw / 2;
    const uint32_t kbase = (uint32_t)(k0 + (wd / TJ) * 32 + (hw % 2) * 16);
    const uint32_t jt = ((uint32_t)(j0 + wd % TJ) * J_SALT) ^ seed_term;
    uint32_t bits = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b) bits |= (mix32(((kbase + b) * K_SALT) ^ jt) & 1u) << b;
    half[hw] = (uint16_t)bits;  // little-endian: half-word 0 holds bits 0-15
  }
}

// One k-tile's products for the NA rows warp, warp + 8, … of this warp and
// the columns lane and lane + 32: each 16-byte load of X (a broadcast) feeds
// eight FMAs. NA is a constant, so no row needs a guard and the loads can
// run ahead.
template <int NA>
__device__ __forceinline__ void tile_products(float (&acc)[RPW][2], const float* xs,
                                              const uint32_t* sg, int lane, int warp, float scale) {
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    uint32_t lo = sg[w * TJ + lane];
    uint32_t hi = sg[w * TJ + lane + 32];
#pragma unroll 2
    for (int kk = 0; kk < 32; kk += 4) {
      float s[2][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[0][b] = (lo >> b) & 1u ? scale : -scale;
        s[1][b] = (hi >> b) & 1u ? scale : -scale;
      }
      lo >>= 4;
      hi >>= 4;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float4 x = *reinterpret_cast<const float4*>(xs + (warp + WARPS * a) * TK + w * 32 + kk);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[a][h] = fmaf(x.x, s[h][0], acc[a][h]);
          acc[a][h] = fmaf(x.y, s[h][1], acc[a][h]);
          acc[a][h] = fmaf(x.z, s[h][2], acc[a][h]);
          acc[a][h] = fmaf(x.w, s[h][3], acc[a][h]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
srp_partial(const float* __restrict__ X, float* __restrict__ partial, int c, int d, int d_prime,
            uint32_t seed_term, float scale, int per, int rows, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);  // STAGES × rows × TK
  uint32_t* Sg = reinterpret_cast<uint32_t*>(Xs + STAGES * rows * TK);  // STAGES × WORDS × TJ

  const int split = blockIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int r0 = blockIdx.z * TR;
  const int lane = threadIdx.x % 32;  // columns lane and lane + 32 of the tile
  const int warp = threadIdx.x / 32;  // rows warp, warp + 8, ..., warp + 56 of the tile
  const int nr = min(TR, c - r0);
  // rows of this warp that exist: warp + 8a < nr
  const int na = (nr - warp + WARPS - 1) / WARPS;

  // the reduce pass may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int n_tiles = (d + TK - 1) / TK;
  const int t_begin = split * per;
  const int nt = max(0, min(per, n_tiles - t_begin));

  // half the threads put the slice's copies in flight while the other half
  // hash its signs; group s of every thread holds k-tile s's copies, if any
  if (threadIdx.x < COPIERS) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (s < nt)
        issue_tile(Xs + s * rows * TK, X, r0, nr, d, (t_begin + s) * TK, vec != 0, threadIdx.x, COPIERS);
      cp_async_commit();
    }
  } else {
    hash_tiles(Sg, t_begin * TK, min(nt, STAGES), j0, seed_term, threadIdx.x - COPIERS,
               THREADS - COPIERS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) cp_async_commit();
  }

  float acc[RPW][2];
#pragma unroll
  for (int a = 0; a < RPW; ++a) acc[a][0] = acc[a][1] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 1>();  // k-tile i has landed
    __syncthreads();              // for every thread, with its signs
    const float* xs = Xs + st * rows * TK;
    const uint32_t* sg = Sg + st * WORDS * TJ;
    switch (na) {  // warp-uniform
#define SRP_ROWS(n) \
  case n:           \
    tile_products<n>(acc, xs, sg, lane, warp, scale); \
    break;
      SRP_ROWS(1) SRP_ROWS(2) SRP_ROWS(3) SRP_ROWS(4) SRP_ROWS(5) SRP_ROWS(6) SRP_ROWS(7) SRP_ROWS(8)
#undef SRP_ROWS
      default:  // no row of this warp exists
        break;
    }
    if (i + STAGES < nt) {  // recycle this stage for k-tile i + STAGES
      __syncthreads();
      issue_tile(Xs + st * rows * TK, X, r0, nr, d, (t_begin + i + STAGES) * TK, vec != 0, threadIdx.x,
                 THREADS);
      hash_tiles(Sg + st * WORDS * TJ, (t_begin + i + STAGES) * TK, 1, j0, seed_term, threadIdx.x, THREADS);
    }
    cp_async_commit();
  }

  float* out = partial + (size_t)split * c * d_prime;
#pragma unroll
  for (int a = 0; a < RPW; ++a) {
    const int row = r0 + warp + WARPS * a;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + lane + 32 * h;
      if (row < c && col < d_prime) out[(size_t)row * d_prime + col] = acc[a][h];
    }
  }
}

// out[i] = ((p₀ + … + p₇) + (p₈ + … + p₁₅)) + … over the split partials p
// of output i. A block takes 32 consecutive outputs: warp g adds the GROUP
// partials of group g with all its loads in flight, and warp 0 adds the
// group sums in group order.
__global__ void __launch_bounds__(32 * MAX_GROUPS)
srp_reduce(const float* __restrict__ partial, float* __restrict__ out, size_t cd) {
  __shared__ float sums[MAX_GROUPS][32];
  const int lane = threadIdx.x % 32;
  const int g = threadIdx.x / 32;
  const int groups = blockDim.x / 32;
  const size_t idx = (size_t)blockIdx.x * 32 + lane;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partial pass has finished
  if (idx < cd) {
    float v[GROUP];
#pragma unroll
    for (int q = 0; q < GROUP; ++q) v[q] = __ldg(partial + (size_t)(g * GROUP + q) * cd + idx);
    float s = v[0];
#pragma unroll
    for (int q = 1; q < GROUP; ++q) s += v[q];
    sums[g][lane] = s;
  }
  __syncthreads();
  if (g == 0 && idx < cd) {
    float s = sums[0][lane];
    for (int q = 1; q < groups; ++q) s += sums[q][lane];
    out[idx] = s;
  }
}

// Dynamic shared memory of a partial-pass block at c rows: the X ring and
// the sign words.
int smem_bytes(int c) {
  const int rows = c < TR ? c : TR;
  return (int)(STAGES * rows * TK * sizeof(float) + STAGES * WORDS * TJ * sizeof(uint32_t));
}

}  // namespace

// X (c, d) f32 -> out (c, d_prime) f32. `partial` is a (splits, c, d_prime)
// f32 scratch the caller allocates; split s sums k-tiles [s·per, (s+1)·per),
// and `splits` is a multiple of GROUP, at most GROUP · MAX_GROUPS.
// `seed_term` is (seed · 0x165667B1) mod 2^32 and `scale` is 1/√d' rounded
// to f32, both computed on the host as the reference does. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int srp_sketch(const float* X, float* partial, float* out, int c, int d, int d_prime,
                          unsigned int seed_term, float scale, int splits, int per, void* stream) {
  if (c < 1 || d < 1 || d_prime < 1 || per < 1 || splits < GROUP || splits % GROUP != 0 ||
      splits > GROUP * MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = c < TR ? c : TR;
  const int smem = smem_bytes(c);
  // the limit of dynamic shared memory set so far, per device (48 KB by default)
  static int smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(srp_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(X) % 16 == 0);
  dim3 grid(splits, (d_prime + TJ - 1) / TJ, (c + TR - 1) / TR);
  srp_partial<<<grid, THREADS, smem, s>>>(X, partial, c, d, d_prime, seed_term, scale, per, rows, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t cd = (size_t)c * d_prime;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((cd + 31) / 32), 1, 1);
  cfg.blockDim = dim3(32 * (splits / GROUP), 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, srp_reduce, (const float*)partial, out, cd);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a partial-pass block for a call with c rows.
extern "C" int srp_smem_bytes(int c) { return smem_bytes(c); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
