// Pairwise Gram (G Gᵀ) and L1 (Σ_k |G_ik − G_jk|) sums over the rows of G.
//
// Replaces the TPU kernels in src/repro/kernels/similarity/kernel.py:
// `pairwise_kernel` (bodies `_gram_kernel`, `_l1_kernel`) and
// `pairwise_kernel_fused` (body `_masked_fused_kernel`). Both compute the
// same function, because zero padding is exact for both ops, so here they
// are one kernel templated on the op that masks its own ragged edges.
//
// Input G is (n, d) f32, row-major and contiguous; the output is (n, n) f32,
// symmetric bit for bit. Arithmetic is full f32 on the CUDA cores: no TF32,
// no tensor cores, because a plan is discrete and a TF32 error can flip a
// Ward merge.
//
// Bound on an H100 SXM at the main path's shape (n = 100, d = 39,760): G is
// 15.9 MB, 4.7 µs at 3.35 TB/s. The i ≤ j half is n(n+1)/2 · d = 200.8 M
// products. The Gram spends one FFMA on each, 6.0 µs at 67 TFLOP/s; L1
// spends two FP32-pipe instructions (FADD a − b, then FADD acc + |·| with
// the |·| as an operand modifier), 12.0 µs. Both are bounded by the FP32
// pipe, and two things starve it. Shared memory: an SM retires 0.49
// LDS.128 a clock where a warp reads 8 or more distinct addresses, 0.66
// where it reads at most 4, one 16-byte value to each lane, while the FP32
// pipe takes 4 warp instructions a clock (kernels/sm_rates.py); so
// a lane's register tile must be large. And the four schedulers of an SM:
// one warp a scheduler reaches 0.75 of the pipe, two 0.88, so an SM needs
// its warps spread evenly. Tiles of the triangle a warp wide (16 × 16,
// 4 × 2 and 4 × 4 a lane) were built first and lost to their loads; 8 × 8
// blocks a lane lost ~10 % to 8 × 4 (blocks of 3 warps, two an SM, leave
// two schedulers one warp); both measured in PERF.md, Findings.
//
// Design:
// * The triangle, cut in TR × TC blocks, one a lane. Rows are cut in
//   groups of TR (the block's rows) or TC (its columns), and in tiles of TG
//   row groups; a block takes a pair of tiles (bi ≤ bj) and one split of
//   d, and its lane t owns task t: block (a, c) of the pair, enumerated row
//   by row, on a diagonal pair only those that reach the i ≤ j half
//   (c ≥ a·TR/TC), and only groups that hold a row < n. Calls with a split
//   d take 8 × 4 blocks (ROW_TILE × COL_TILE) in 128-row tiles: at
//   n = 100, 169 tasks of 32 entries, 5,408 products a column of d where
//   5,050 are needed (1.07×), in 6 warps, two blocks an SM: three warps a
//   scheduler. Each step of 4 columns of d a lane loads 8 + 4 float4
//   (LDS.128) for 128 products. Entries below the diagonal of a diagonal
//   block are computed and never written: the lower triangle is written
//   as the mirror of the upper, so out == out.T bit for bit.
// * Loads without bank conflicts. Lanes of a quarter-warp share a row group
//   (one address, a broadcast) or hold neighbouring column groups. A shared
//   row is BK + 4 floats and each group of 8 rows is skewed by one more
//   16-byte unit, so row r of 4-column piece p lies in bank group
//   (r + r / 8 + p) mod 8: eight neighbouring column groups of 4 rows never
//   meet.
// * Copies in flight. d is walked in chunks of BK = 32 columns through a
//   ring of STAGES shared-memory stages filled by `cp.async`: while chunk t
//   is multiplied, chunks t + 1 and t + 2 are on their way. A diagonal pair
//   copies one row tile, any other pair two. A copy is 16 bytes where
//   d % 4 == 0 and G is 16-byte aligned (rows then are too), else 4 bytes;
//   columns ≥ d and rows ≥ n arrive as zeros through the copy's source
//   size. Each entry sums its k in ascending order.
// * Split and reduce in a fixed order. d is split so that a call has about
//   TARGET_BLOCKS blocks (kernels/similarity/ops.py `split_plan`, a
//   function of (n, d) only, never of the card). Each split writes its sums
//   to a scratch lane by lane, entry (q, r) of 32 lanes in 128 contiguous
//   bytes, and a second kernel adds them in a fixed order, each group of
//   GROUP splits in split order and then the group sums in group order,
//   ((p₀ + … + p₇) + (p₈ + … + p₁₅)) + …, one warp a group with its loads
//   all in flight. It is a programmatic dependent launch of the first
//   (scheduled as the first starts, held by `griddepcontrol.wait`), and
//   writes each sum and its mirror. No float atomics: the result is
//   bit-reproducible.
// * One split, one launch. Where d is short (the sketched store's d′ = 64)
//   the plan has one split and the partial pass writes both triangles of
//   `out` itself. There the time is latency, not issue: the blocks are
//   4 × 4 a lane (SMALL_TILE) in 16-row tiles, so 28 blocks share n = 100
//   and a lane holds half the sums of a split call's lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;              // columns of d a chunk (a ring stage)
constexpr int LD = BK + 4;          // floats a shared row
constexpr int ROW_TILE = 8;         // rows of a lane's block in a split call
constexpr int COL_TILE = 4;         // its columns
constexpr int TILE_GROUPS = 16;     // row groups of a tile in a split call: 128 rows
constexpr int SMALL_TILE = 4;       // rows and columns of a lane's block in a one-split call
constexpr int SMALL_GROUPS = 4;     // its row groups a tile: 16 rows
constexpr int STAGES = 3;           // chunks in the ring
// the tasks of an off-diagonal pair in a split call
constexpr int MAX_THREADS = TILE_GROUPS * TILE_GROUPS * ROW_TILE / COL_TILE;
constexpr int GROUP = 8;            // splits the reduction adds in order first
constexpr int MAX_GROUPS = 64;      // 512 splits at most
// warps of a reduce block: with two partial-pass blocks an SM its
// registers still fit beside them, so it is resident before they finish
constexpr int REDUCE_WARPS = 16;
constexpr int MAX_DEVICES = 64;

enum Op { GRAM = 0, L1 = 1 };

// floats of a row group of TR rows in shared memory: skewed by one 16-byte unit
template <int TR>
__host__ __device__ constexpr int group_floats() { return TR * LD + 4; }

template <int TR>
__device__ __forceinline__ int row_offset(int r) { return (r / TR) * group_floats<TR>() + (r % TR) * LD; }

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

// Request rows [r0, r0 + nr) × columns [k0, k0 + BK) of G into the tile
// `dst`. Rows ≥ n and columns ≥ d arrive as zeros.
template <int TR>
__device__ __forceinline__ void issue_rows(float* dst, const float* __restrict__ G, int r0, int nr,
                                           int n, int d, int k0, bool vec) {
  if (vec) {  // d % 4 == 0: a 4-column piece lies wholly inside or outside d
    for (int e = threadIdx.x; e < nr * (BK / 4); e += blockDim.x) {
      const int r = e / (BK / 4);
      const int col = k0 + 4 * (e % (BK / 4));
      const bool in = r0 + r < n && col < d;
      cp_async16(dst + row_offset<TR>(r) + (col - k0), in ? G + (size_t)(r0 + r) * d + col : G,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nr * BK; e += blockDim.x) {
      const int r = e / BK;
      const int col = k0 + e % BK;
      const bool in = r0 + r < n && col < d;
      cp_async4(dst + row_offset<TR>(r) + (col - k0), in ? G + (size_t)(r0 + r) * d + col : G,
                in ? 4 : 0);
    }
  }
}

template <int OP>
__device__ __forceinline__ float step(float acc, float a, float b) {
  if (OP == GRAM) return fmaf(a, b, acc);
  return acc + fabsf(a - b);
}

template <int E>
__device__ __forceinline__ float part(float4 v) {
  return E == 0 ? v.x : E == 1 ? v.y : E == 2 ? v.z : v.w;
}

// Column E of a step into every entry of the block: the TR·TC sums are
// independent, so an entry's next product comes TR·TC instructions later.
template <int OP, int TR, int TC, int E>
__device__ __forceinline__ void column(float (&acc)[TR][TC], const float4 (&x)[TR], const float4 (&y)[TC]) {
#pragma unroll
  for (int r = 0; r < TC; ++r)
#pragma unroll
    for (int q = 0; q < TR; ++q) acc[q][r] = step<OP>(acc[q][r], part<E>(x[q]), part<E>(y[r]));
}

template <int TR, int TC>
__device__ __forceinline__ void load_step(float4 (&x)[TR], float4 (&y)[TC], const float* as, const float* bs,
                                          int kk) {
#pragma unroll
  for (int q = 0; q < TR; ++q) x[q] = *reinterpret_cast<const float4*>(as + q * LD + kk);
#pragma unroll
  for (int r = 0; r < TC; ++r) y[r] = *reinterpret_cast<const float4*>(bs + r * LD + kk);
}

template <int OP, int TR, int TC>
__device__ __forceinline__ void step_products(float (&acc)[TR][TC], const float4 (&x)[TR],
                                              const float4 (&y)[TC]) {
  column<OP, TR, TC, 0>(acc, x, y);
  column<OP, TR, TC, 1>(acc, x, y);
  column<OP, TR, TC, 2>(acc, x, y);
  column<OP, TR, TC, 3>(acc, x, y);
}

// One chunk's products of a lane's TR × TC block: `as` and `bs` point at
// the first shared row of its row group and of its column group. Four
// columns of d a step, TR + TC loads of 16 bytes for TR·TC·4 products,
// each entry's k in ascending order. The steps are unrolled, so the
// compiler issues a step's loads among the previous step's products.
template <int OP, int TR, int TC>
__device__ __forceinline__ void chunk_products(float (&acc)[TR][TC], const float* as, const float* bs) {
  float4 x[TR], y[TC];
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    load_step<TR, TC>(x, y, as, bs, kk);
    step_products<OP, TR, TC>(acc, x, y);
  }
}

// Tile pair p -> (bi, bj) with bi <= bj, enumerated row by row.
__device__ __forceinline__ int2 pair_of(int p, int n_tiles) {
  int bi = 0;
  while (p >= n_tiles - bi) {
    p -= n_tiles - bi;
    ++bi;
  }
  return make_int2(bi, bi + p);
}

// Lane t's task in a pair of tiles with ga row groups (of tr rows) and gc
// column groups (of tc rows) that hold a row < n: block (a, c), enumerated
// row by row, on a diagonal pair only those that reach the i ≤ j half
// (c ≥ a·tr/tc); a = −1 where the lane has none.
__device__ __forceinline__ int2 task_of(int t, bool diag, int ga, int gc, int tr, int tc) {
  if (!diag) return t < ga * gc ? make_int2(t / gc, t % gc) : make_int2(-1, 0);
  for (int a = 0; a < ga; ++a) {
    const int c0 = a * tr / tc;
    if (t < gc - c0) return make_int2(a, c0 + t);
    t -= gc - c0;
  }
  return make_int2(-1, 0);
}

// Groups of g rows of tile b (of `rows` rows) that hold a row < n.
__device__ __forceinline__ int groups_in(int b, int rows, int g, int n) {
  return min(rows / g, (n - b * rows + g - 1) / g);
}

// Grid (tile pairs, splits), a lane a task; a tile is TG row groups of TR
// rows. `tile_floats` is the shared memory of one tile of a stage (its row
// groups that hold a row < n). With one split the sums go to `out`, else to
// `partial` as (splits, tile pairs, TR·TC, lanes): entry (q, r) of every
// lane's block side by side, so each store of a warp is 128 contiguous
// bytes.
template <int OP, int TR, int TC, int TG>
__global__ void __launch_bounds__(MAX_THREADS)
pairwise_partial(const float* __restrict__ G, float* __restrict__ partial, float* __restrict__ out,
                 int n, int d, int n_tiles, int per, int vec, int tile_floats) {
  extern __shared__ __align__(16) float smem[];  // STAGES × (row tile[, column tile])

  // the reduce pass may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  constexpr int ROWS = TR * TG;  // rows of a tile
  const int2 bij = pair_of(blockIdx.x, n_tiles);
  const bool diag = bij.x == bij.y;
  const int i0 = bij.x * ROWS;
  const int j0 = bij.y * ROWS;
  const int ga = groups_in(bij.x, ROWS, TR, n);
  const int stage_floats = (n_tiles > 1 ? 2 : 1) * tile_floats;
  // this lane's block (a, c): rows i0 + TR·a …, columns j0 + TC·c …
  const int2 ac = task_of(threadIdx.x, diag, ga, groups_in(bij.y, ROWS, TC, n), TR, TC);

  const int n_chunks = (d + BK - 1) / BK;
  const int c_begin = blockIdx.y * per;
  const int nc = max(0, min(per, n_chunks - c_begin));

  auto issue = [&](int s, int chunk) {
    float* st = smem + s * stage_floats;
    issue_rows<TR>(st, G, i0, ga * TR, n, d, chunk * BK, vec != 0);
    if (!diag)
      issue_rows<TR>(st + tile_floats, G, j0, groups_in(bij.y, ROWS, TR, n) * TR, n, d, chunk * BK, vec != 0);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nc) issue(s, c_begin + s);
    cp_async_commit();
  }

  float acc[TR][TC];
#pragma unroll
  for (int q = 0; q < TR; ++q)
#pragma unroll
    for (int r = 0; r < TC; ++r) acc[q][r] = 0.f;

  for (int i = 0; i < nc; ++i) {
    cp_async_wait<STAGES - 2>();  // chunk i has landed
    __syncthreads();              // for every thread; and chunk i − 1's stage is free
    if (i + STAGES - 1 < nc) issue((i + STAGES - 1) % STAGES, c_begin + i + STAGES - 1);
    cp_async_commit();
    const float* st = smem + (i % STAGES) * stage_floats;
    if (ac.x >= 0)
      chunk_products<OP, TR, TC>(acc, st + ac.x * group_floats<TR>(),
                                 (diag ? st : st + tile_floats) + row_offset<TR>(TC * ac.y));
  }

  if (gridDim.y > 1) {
    if (ac.x < 0) return;
    float* dst = partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (TR * TC) * blockDim.x + threadIdx.x;
#pragma unroll
    for (int q = 0; q < TR; ++q)
#pragma unroll
      for (int r = 0; r < TC; ++r) dst[(size_t)(q * TC + r) * blockDim.x] = acc[q][r];
    return;
  }
  if (ac.x < 0) return;
#pragma unroll
  for (int q = 0; q < TR; ++q) {
    const int row = i0 + TR * ac.x + q;
#pragma unroll
    for (int r = 0; r < TC; ++r) {
      const int col = j0 + TC * ac.y + r;
      if (row <= col && col < n) {
        out[(size_t)row * n + col] = acc[q][r];
        out[(size_t)col * n + row] = acc[q][r];
      }
    }
  }
}

// out[i, j] = out[j, i] = ((p₀ + … + p₇) + (p₈ + … + p₁₅)) + … over the
// split partials p of entry (i, j), i ≤ j; the last group may hold fewer
// than GROUP. A block takes 32 consecutive partial entries (one (q, r) of
// 32 lanes of one tile pair): its warp w adds the partials of groups w,
// w + warps, … (a group's loads all in flight), and warp 0 adds the group
// sums in group order and writes the entries that lie in the i ≤ j
// triangle of out. The lane tile is tr × tc in tiles of tg row groups.
__global__ void __launch_bounds__(32 * REDUCE_WARPS)
pairwise_reduce(const float* __restrict__ partial, float* __restrict__ out, int n, int splits, int tr,
                int tc, int tg, int n_tiles, int lanes) {
  __shared__ float sums[MAX_GROUPS][32];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int groups = (splits + GROUP - 1) / GROUP;
  const int rows = tr * tg;
  const size_t per_split = (size_t)n_tiles * (n_tiles + 1) / 2 * tr * tc * lanes;
  const size_t t = (size_t)blockIdx.x * 32 + lane;
  const int l = (int)(t % lanes);
  const int e = (int)(t / lanes % (tr * tc));
  const int2 bij = pair_of((int)(t / lanes / (tr * tc)), n_tiles);
  const int2 ac = task_of(l, bij.x == bij.y, groups_in(bij.x, rows, tr, n), groups_in(bij.y, rows, tc, n), tr, tc);
  const int i = bij.x * rows + tr * ac.x + e / tc;
  const int j = bij.y * rows + tc * ac.y + e % tc;
  const bool in = ac.x >= 0 && i <= j && j < n;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partial pass has finished
  if (in) {
    for (int g = w; g < groups; g += warps) {
      float v[GROUP];
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
        v[q] = g * GROUP + q < splits ? __ldg(partial + (size_t)(g * GROUP + q) * per_split + t) : 0.f;
      float s = v[0];
#pragma unroll
      for (int q = 1; q < GROUP; ++q)
        if (g * GROUP + q < splits) s += v[q];
      sums[g][lane] = s;
    }
  }
  __syncthreads();
  if (w == 0 && in) {
    float s = sums[0][lane];
    for (int g = 1; g < groups; ++g) s += sums[g][lane];
    out[(size_t)i * n + j] = s;
    out[(size_t)j * n + i] = s;
  }
}

// A call's shape: a lane's block is tr × tc, a tile tg row groups of tr
// rows; tiles and tile pairs; row groups a tile holds in shared memory;
// lanes a block (one a task: the triangle of a lone tile, else a full pair).
struct Shape {
  int tr, tc, tg, n_tiles, pairs, tile_groups, lanes;
};

Shape shape_of(int n, int ts) {
  Shape sh;
  sh.tr = ts == 8 ? ROW_TILE : SMALL_TILE;
  sh.tc = ts == 8 ? COL_TILE : SMALL_TILE;
  sh.tg = ts == 8 ? TILE_GROUPS : SMALL_GROUPS;
  const int rows = sh.tr * sh.tg;
  sh.n_tiles = (n + rows - 1) / rows;
  sh.pairs = sh.n_tiles * (sh.n_tiles + 1) / 2;
  const int ga = (n + sh.tr - 1) / sh.tr;
  sh.tile_groups = ga < sh.tg ? ga : sh.tg;
  int tasks = sh.tg * sh.tg * sh.tr / sh.tc;
  if (sh.n_tiles == 1) {
    const int gc = (n + sh.tc - 1) / sh.tc;
    tasks = 0;
    for (int a = 0; a < ga; ++a) tasks += gc - a * sh.tr / sh.tc;
  }
  sh.lanes = (tasks + 31) / 32 * 32;
  return sh;
}

// Floats of one split's sums: tr·tc entries of every lane of every tile pair.
long long scratch_floats(int n, int ts) {
  const Shape sh = shape_of(n, ts);
  return (long long)sh.pairs * sh.tr * sh.tc * sh.lanes;
}

// The partial pass of a call of shape `sh` (its tr, tc and tg are TR, TC and TG).
template <int OP, int TR, int TC, int TG>
cudaError_t launch_partial(const float* G, float* partial, float* out, int n, int d, int splits, int per,
                           const Shape& sh, cudaStream_t s) {
  // the limit of dynamic shared memory set so far, per device (48 KB by default)
  static int smem_set[MAX_DEVICES] = {};
  const int tile_floats = sh.tile_groups * group_floats<TR>();
  const int smem = STAGES * (sh.n_tiles > 1 ? 2 : 1) * tile_floats * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(pairwise_partial<OP, TR, TC, TG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  const int vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(G) % 16 == 0);
  const dim3 grid(sh.pairs, splits);
  pairwise_partial<OP, TR, TC, TG><<<grid, sh.lanes, smem, s>>>(G, partial, out, n, d, sh.n_tiles, per, vec,
                                                                 tile_floats);
  return cudaGetLastError();
}

}  // namespace

// G (n, d) f32 -> out (n, n) f32. Split s sums chunks [s·per, (s+1)·per) of
// BK columns; with splits > 1, `partial` is an f32 scratch of
// pairwise_scratch_floats(n, ts) a split that the caller allocates (unused
// with one split), and splits ≤ GROUP · MAX_GROUPS. `op` is 0 for the
// Gram, 1 for L1; `ts` picks the lane tile: 8 for ROW_TILE × COL_TILE in
// 128-row tiles, 4 for 4 × 4 in 16-row tiles. Returns the cudaError_t of
// the launches (0 = success).
extern "C" int pairwise_sums(const float* G, float* partial, float* out, int n, int d, int op,
                             int splits, int per, int ts, void* stream) {
  if (n < 1 || d < 1 || per < 1 || splits < 1 || splits > GROUP * MAX_GROUPS || (op != GRAM && op != L1) ||
      (ts != 4 && ts != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Shape sh = shape_of(n, ts);
  cudaError_t err;
  if (op == GRAM)
    err = ts == 8 ? launch_partial<GRAM, ROW_TILE, COL_TILE, TILE_GROUPS>(G, partial, out, n, d, splits, per, sh, s)
                  : launch_partial<GRAM, SMALL_TILE, SMALL_TILE, SMALL_GROUPS>(G, partial, out, n, d, splits, per,
                                                                                sh, s);
  else
    err = ts == 8 ? launch_partial<L1, ROW_TILE, COL_TILE, TILE_GROUPS>(G, partial, out, n, d, splits, per, sh, s)
                  : launch_partial<L1, SMALL_TILE, SMALL_TILE, SMALL_GROUPS>(G, partial, out, n, d, splits, per,
                                                                              sh, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int groups = (splits + GROUP - 1) / GROUP;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(scratch_floats(n, ts) / 32), 1, 1);
  cfg.blockDim = dim3(32 * (groups < REDUCE_WARPS ? groups : REDUCE_WARPS), 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pairwise_reduce, (const float*)partial, out, n, splits, sh.tr, sh.tc, sh.tg,
                           sh.n_tiles, sh.lanes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Floats of the partial-sum scratch a split takes at lane tile ts.
extern "C" long long pairwise_scratch_floats(int n, int ts) { return scratch_floats(n, ts); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
