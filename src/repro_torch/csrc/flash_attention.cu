// Causal GQA flash attention, forward, with an online softmax:
//
//   out[b, i, h] = Σ_j softmax_j(q[b, i, h]·k[b, j, g] · hd^-½) v[b, j, g],
//   g = h / (H / KV), masked to j <= i when causal and always to j < T.
//
// Replaces the TPU kernel `_flash_kernel` (wrapper `flash_attention`) in
// src/repro/kernels/flash_attention/kernel.py:29/:70, and the padding of
// `flash_attention_padded` in ops.py: every kernel here takes the true S
// and T and masks the ragged tails itself. Like the reference it takes any
// head dim, any B and H, and any layout of q, k and v.
//
// Routes, chosen by dtype and head dim in the two entry points at the end:
//   - bf16 and f16, hd <= 256: `flash_fwd_mma<T, HDP>`, on the tensor cores
//     (mma.sync m16n8k16), hd padded to HDP = 32, 64, 128 or 256;
//   - bf16 and f16, hd > 256: `flash_fwd_mma_wide<T>`, the same products
//     with the head dim cut into 128-column chunks (below);
//   - f32: `flash_fwd_f32<float, float>`, on the CUDA cores, every product
//     an f32 FMA, head dims above 128 cut into 128-column chunks the same
//     way. It is the f32 route because TF32 is not allowed where the port
//     is held to the reference at atol 2e-5;
//   - q, k and v of mixed dtypes (`flash_attention_fwd_mixed`): the same
//     kernel, `flash_fwd_f32<TV, TO>`, with v read in its own dtype TV, p
//     rounded to TV before the PV product and the output written in q's
//     dtype TO. q and k come in f32: the wrapper widens a bf16 or f16 q or
//     k exactly, and a product of two widened 16-bit values (bf16 × f16
//     included) is exact in f32, as the reference's f32 dot of them is.
//
// Semantics shared by all, which the plain version `flash_attention_plain`
// computes: scores in f32 from the inputs (bf16 and f16 products are exact
// in f32), scaled after the dot; a finite mask value NEG = -1e30, never
// -inf, so exp(m_prev - m_new) is never NaN; the running max m, the f32
// denominator l (of the unrounded p) and the f32 accumulator carried across
// k-tiles in a fixed order (no split over keys, no atomics:
// bit-reproducible); p rounded to v's dtype before the PV product; the
// output divided by max(l, 1e-30) and cast to q's dtype once. With causal
// masking the first k-tile holds key 0 for every real query row, so no real
// row is ever fully masked. The k-tiles wholly above the diagonal would add
// exactly 0 (exp(NEG - m) underflows to 0 and alpha is 1), so they are
// skipped.
//
// Layout: q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), each
// read or written through its strides (in elements; unit stride along hd),
// so the model's (B, S, H·hd) activations need no transposed copies. GQA is
// index arithmetic: k and v are never repeated. The grid is one axis,
// (q-tile, output chunk, head, batch) with the q-tile fastest, so B·H has
// no limit below 2³¹ blocks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;

struct Strides {  // in elements, for the batch, sequence and head axes
  long long b, s, h;
};

// The bytes of each copy of a row of q, k and v into shared memory (16, 8
// or 4 by cp.async, 2 by plain loads), and whether the output takes 4-byte
// stores of two columns.
struct Widths {
  int q, k, v, opair;
};

// This block's q-tile start, output chunk, head and batch, from the one
// grid axis: q-tiles fastest, issued from the last (the longest causal
// row) first.
struct Block {
  int q0, oc, h, b;
};

__device__ __forceinline__ Block block_of(int nq, int nc, int H, int bq) {
  unsigned id = blockIdx.x;
  const int qt = id % nq;
  id /= nq;
  const int oc = id % nc;
  id /= nc;
  return {(nq - 1 - qt) * bq, oc, (int)(id % H), (int)(id / H)};
}

// ---------------------------------------------------------------------------
// bf16 and f16 routes: flash_fwd_mma and flash_fwd_mma_wide
//
// What bounds it on an H100 SXM at the serve path's shape (B = 4,
// S = T = 1,000, H = 12, KV = 2, hd = 128): 2·B·H·S²·hd = 12.29 GFLOP of
// causal work, 0.0124 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against 28.7 MB of inputs and outputs, 0.0086 ms at 3.35 TB/s: it is
// bound by tensor-core operations. The design, FlashAttention-2's shape:
//
// - One block of 4 warps per (64-row q-tile, head, batch); each warp owns
//   16 query rows.
// - Q, K and V tiles are copied from device memory with cp.async, 16 bytes
//   a thread, rows past S or T and the head-dim pad zero-filled. K and V
//   tiles of 64 keys (32 at HDP 256) are double-buffered: tile j + 1 is in
//   flight while tile j's products run. One barrier per k-tile. An operand whose base,
//   strides or head dim break 16-byte alignment is copied 8 or 4 bytes at
//   a time by cp.async, or by 2-byte loads: the width is chosen per operand
//   at launch, and the products do not change.
// - Tiles stay 16-bit in shared memory, rows padded by 8 elements (16 B),
//   so the 8 row addresses of each ldmatrix fall in 8 distinct 16-byte bank
//   groups: no bank conflicts. At hd 128 that is 17,408 B of Q and 69,632 B
//   for two stages of K and V, 87,040 B: two blocks fit on an SM. At HDP
//   256, 33,792 B of Q and 67,584 B of 32-key stages, 101,376 B: two.
// - S = QKᵀ on mma.sync.m16n8k16 (bf16 or f16 in, f32 accumulate): up to
//   HDP 128 Q's A fragments are loaded once by ldmatrix and kept in
//   registers. At HDP 256 the warp's O accumulator alone is 16 × 256 f32,
//   128 registers a thread, and Q's fragments would be 64 more: Q stays in
//   shared memory and its fragments are reloaded by ldmatrix each k-tile,
//   and the k-tiles hold 32 keys, so S and P take half the registers.
//   K's B fragments come by ldmatrix from the row-major (key, dim) tile.
// - The online softmax runs on the accumulator fragments: a row lives in a
//   quad of 4 lanes, reduced by two xor shuffles. exp2 with log₂e folded
//   into the scale.
// - O += PV: two adjacent m16n8 accumulators of S are exactly one m16n8k16
//   A fragment, so P goes from registers to the next product without
//   shared memory. V's B fragments come by ldmatrix.trans. O stays in
//   registers, 16 × HDP f32 a warp.
// - Only the k-tiles that cross the diagonal or hold the ragged T tail are
//   masked element by element.
// - Template on the element type and the padded head dim HDP (32, 64, 128,
//   256): hd is rounded up to the next HDP, the pad columns of Q and K are
//   zero in shared memory (so they add 0 to every dot), and output columns
//   >= hd are never written.
// - Above 256 (flash_fwd_mma_wide) the output's head dim is cut into
//   128-column chunks, one block each (the grid's chunk axis). A block
//   computes the scores over the whole hd, walking Q and K through shared
//   memory in 128-column chunks, and accumulates PV only for its chunk of V
//   and O: QKᵀ is computed once per chunk of the output, the cost of any
//   width. Its tiles are single-buffered.
// mma.sync rather than wgmma + TMA: P is the next product's register
// operand with no change of layout, and nothing depends on a shared-memory
// descriptor or a driver-built tensor map.
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;  // query rows per block, 16 per warp
constexpr int MMA_THREADS = 128;
constexpr int WIDE_DC = 128;  // head-dim chunk of flash_fwd_mma_wide

// The tiles of a padded head dim HDP: 64 query rows, and k-tiles of BK keys,
// 64 up to HDP 128 and 32 at 256, where a warp's 16 × 256 f32 accumulator
// leaves no room for 64 keys' scores and P fragments beside it (with 64,
// ptxas spills at 255 registers). Blocks an SM at each HDP (32, 64, 128,
// 256): 4, 3, 2 and 2, so that each keeps its registers within
// 65,536 / (blocks · 128).
template <int HDP>
struct MmaTile {
  static constexpr int BK = HDP > 128 ? 32 : 64;  // keys per k-tile
  static constexpr int LD = HDP + 8;              // row stride in elements
  static constexpr int Q_ELEMS = MMA_BQ * LD;     // the q-tile
  static constexpr int KV_ELEMS = BK * LD;        // one k-tile of K or of V
  static constexpr size_t SMEM = (Q_ELEMS + 4 * KV_ELEMS) * sizeof(uint16_t);  // Q + 2 × (K, V)
  static constexpr int BLOCKS = HDP == 32 ? 4 : HDP == 64 ? 3 : 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16, 8 or 4 bytes from global to shared; with `in` false they are zeroed
// and `src` is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The element type's tensor-core product and rounding. mma: d += a·b for
// one m16n8k16 tile, a the 16×16 A fragment, (b0, b1) the 16×8 B fragment,
// d the 16×8 f32 accumulator. pack: two floats rounded to the type, lo in
// the low half (the lower column).
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// Rows row0 .. row0 + ROWS - 1 of a (rows, ncols) operand into a (ROWS,
// LD) tile of HDP columns: rows >= nrows and columns >= ncols are
// zero-filled. `width` is the bytes of each copy: 16 (the kernels' own
// layouts), else the narrower path, whose loop and division cost only such
// operands.
template <int HDP, int ROWS>
__device__ __forceinline__ void copy_tile(uint16_t* dst, const uint16_t* src, long long row_stride,
                                          int row0, int nrows, int ncols, int width, int tid) {
  constexpr int LD = MmaTile<HDP>::LD;
  if (width == 16) {
    constexpr int CPR = HDP / 8;  // 16-byte chunks per row
#pragma unroll
    for (int i = 0; i < ROWS * CPR / MMA_THREADS; ++i) {
      const int idx = tid + i * MMA_THREADS;
      const int r = idx / CPR, c = idx % CPR;
      const bool in = row0 + r < nrows && c * 8 < ncols;
      const uint16_t* g = in ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
      cp_async16(dst + r * LD + c * 8, g, in);
    }
    return;
  }
  const int per = width / 2;  // elements a copy
  const int cpr = HDP / per;
  for (int idx = tid; idx < ROWS * cpr; idx += MMA_THREADS) {
    const int r = idx / cpr, c = idx - r * cpr;
    const bool in = row0 + r < nrows && c * per < ncols;
    const uint16_t* g = in ? src + (long long)(row0 + r) * row_stride + c * per : src;
    uint16_t* d = dst + r * LD + c * per;
    if (width == 8)
      cp_async8(d, g, in);
    else if (width == 4)
      cp_async4(d, g, in);
    else
      *d = in ? *g : uint16_t(0);
  }
}

// S += Q Kᵀ over one 16-column k-step: the warp's A fragment `a` against
// the BK keys of the tile cK, n-block by n-block.
template <typename T, int LD, int BK>
__device__ __forceinline__ void qk_step(float (&s)[BK / 8][4], const uint32_t (&a)[4],
                                        const uint16_t* cK, int kk, int mi, int mr) {
#pragma unroll
  for (int n2 = 0; n2 < BK / 16; ++n2) {
    // matrices: keys 16·n2 + {0, 8} × dims 16·kk + {0, 8}
    uint32_t kf[4];
    ldmatrix_x4(kf, cK + (n2 * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
    Elem<T>::mma(s[2 * n2], a, kf[0], kf[1]);
    Elem<T>::mma(s[2 * n2 + 1], a, kf[2], kf[3]);
  }
}

// Scale, mask and the online softmax on the fragments of one k-tile's S:
// m and l are updated, O rescaled, and P returned as the A fragments of PV,
// rounded to T.
template <typename T, int NB_O, int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[NB_O][4], uint32_t (&pf)[BK / 16][4],
                                             bool masked, int k0, int row0, int Tk, int causal,
                                             int tig, float scale_log2) {
  constexpr int NB_S = BK / 8;
  float tmax[2] = {NEG, NEG};
#pragma unroll
  for (int n = 0; n < NB_S; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_log2;
      if (masked) {
        const int col = k0 + n * 8 + 2 * tig + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= Tk || (causal && col > row)) x = NEG;
      }
      s[n][e] = x;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NB_S; ++n) {
    const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
    const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
    psum[0] += p0 + p1;
    psum[1] += p2 + p3;
    pf[n >> 1][2 * (n & 1)] = Elem<T>::pack(p0, p1);      // row grp
    pf[n >> 1][2 * (n & 1) + 1] = Elem<T>::pack(p2, p3);  // row grp + 8
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
  for (int n = 0; n < NB_O; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// O += P V over the BK keys of the tile cV.
template <typename T, int LD, int NB_O, int BK>
__device__ __forceinline__ void pv_step(float (&o)[NB_O][4], const uint32_t (&pf)[BK / 16][4],
                                        const uint16_t* cV, int mi, int mr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < NB_O / 2; ++n2) {
      // matrices: keys 16·kk + {0, 8} × dims 16·n2 + {0, 8}, transposed
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, cV + (kk * 16 + (mi & 1) * 8 + mr) * LD + n2 * 16 + (mi >> 1) * 8);
      Elem<T>::mma(o[2 * n2], pf[kk], vf[0], vf[1]);
      Elem<T>::mma(o[2 * n2 + 1], pf[kk], vf[2], vf[3]);
    }
  }
}

// The warp's rows of O divided by their denominators (the sum over each
// row's quad, in one fixed order) and written as T: columns col0 + n·8 +
// 2·tig (+1) below hd, two a 4-byte store where `pair` allows it.
template <typename T, int NB_O>
__device__ __forceinline__ void store_out(uint16_t* ob, long long row_stride, float (&o)[NB_O][4],
                                          float (&l)[2], int row0, int S, int col0, int hd, int tig,
                                          int pair) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NB_O; ++n) {
    const int col = col0 + n * 8 + 2 * tig;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= S) continue;
      const uint32_t two = Elem<T>::pack(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
      uint16_t* dst = ob + (long long)row * row_stride + col;
      if (pair && col + 1 < hd) {
        *reinterpret_cast<uint32_t*>(dst) = two;
      } else {
        dst[0] = uint16_t(two & 0xffffu);
        if (col + 1 < hd) dst[1] = uint16_t(two >> 16);
      }
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(MMA_THREADS, MmaTile<HDP>::BLOCKS)
flash_fwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int nq, int S, int Tk,
              int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, Widths w,
              float scale_log2, int causal) {
  constexpr int BK = MmaTile<HDP>::BK;
  constexpr int LD = MmaTile<HDP>::LD;
  constexpr int ELEMS = MmaTile<HDP>::KV_ELEMS;
  constexpr int KSTEPS = HDP / 16;   // k-steps of QKᵀ over the head dim
  constexpr int NB_S = BK / 8;       // n-blocks of S over the keys
  constexpr int PSTEPS = BK / 16;    // k-steps of PV over the keys
  constexpr int NB_O = HDP / 8;      // n-blocks of O over the head dim
  constexpr bool QREG = HDP <= 128;  // Q's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + MmaTile<HDP>::Q_ELEMS;  // two stages
  uint16_t* sV = sK + 2 * ELEMS;              // two stages

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the fragment's row group and column pair
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: which 8×8 matrix, which row of it
  const Block blk = block_of(nq, 1, H, MMA_BQ);
  const int q0 = blk.q0, h = blk.h, b = blk.b;
  const int g = h / (H / KV);

  const uint16_t* qb = q + b * qs.b + h * qs.h;
  const uint16_t* kb = k + b * ks.b + g * ks.h;
  const uint16_t* vb = v + b * vs.b + g * vs.h;

  copy_tile<HDP, MMA_BQ>(sQ, qb, qs.s, q0, S, hd, w.q, tid);
  copy_tile<HDP, BK>(sK, kb, ks.s, 0, Tk, hd, w.k, tid);
  copy_tile<HDP, BK>(sV, vb, vs.s, 0, Tk, hd, w.v, tid);
  cp_async_commit();

  uint32_t qf[QREG ? KSTEPS : 1][4];
  float o[NB_O][4];
#pragma unroll
  for (int n = 0; n < NB_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG};  // running max (log2 domain) of rows grp and grp + 8
  float l[2] = {0.f, 0.f};  // this lane's part of their denominators
  const int row0 = q0 + warp * 16 + grp;  // and row0 + 8
  const uint16_t* aQ = sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;  // + kk·16

  const int kend = causal ? min(Tk, q0 + MMA_BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    // tile j has landed for every thread, and every warp is done with
    // tile j - 1, whose stage the next copy overwrites
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles) {
      const int st = (j + 1) & 1;
      copy_tile<HDP, BK>(sK + st * ELEMS, kb, ks.s, k0 + BK, Tk, hd, w.k, tid);
      copy_tile<HDP, BK>(sV + st * ELEMS, vb, vs.s, k0 + BK, Tk, hd, w.v, tid);
    }
    cp_async_commit();
    if constexpr (QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], aQ + kk * 16);
      }
    }
    const uint16_t* cK = sK + (j & 1) * ELEMS;
    const uint16_t* cV = sV + (j & 1) * ELEMS;

    // S = Q Kᵀ: 16 rows × BK keys a warp
    float s[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (QREG) {
        qk_step<T, LD, BK>(s, qf[kk], cK, kk, mi, mr);
      } else {
        uint32_t a[4];
        ldmatrix_x4(a, aQ + kk * 16);
        qk_step<T, LD, BK>(s, a, cK, kk, mi, mr);
      }
    }

    const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > q0);
    uint32_t pf[PSTEPS][4];  // P as the A fragments of PV, rounded to T
    softmax_step<T, NB_O, BK>(s, m, l, o, pf, masked, k0, row0, Tk, causal, tig, scale_log2);
    pv_step<T, LD, NB_O, BK>(o, pf, cV, mi, mr);
  }

  store_out<T, NB_O>(out + b * os.b + h * os.h, os.s, o, l, row0, S, 0, hd, tig, w.opair);
}

template <typename T>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_fwd_mma_wide(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int nq, int nc,
                   int S, int Tk, int H, int KV, int hd, Strides qs, Strides ks, Strides vs,
                   Strides os, Widths w, float scale_log2, int causal) {
  constexpr int HDP = WIDE_DC;
  constexpr int BK = MmaTile<HDP>::BK;
  constexpr int LD = MmaTile<HDP>::LD;
  constexpr int NB_S = BK / 8;
  constexpr int PSTEPS = BK / 16;
  constexpr int NB_O = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* sK = sQ + MmaTile<HDP>::Q_ELEMS;
  uint16_t* sV = sK + MmaTile<HDP>::KV_ELEMS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const Block blk = block_of(nq, nc, H, MMA_BQ);
  const int q0 = blk.q0, h = blk.h, b = blk.b;
  const int oc0 = blk.oc * HDP;  // this block's output columns: oc0 .. oc0 + 127
  const int g = h / (H / KV);

  const uint16_t* qb = q + b * qs.b + h * qs.h;
  const uint16_t* kb = k + b * ks.b + g * ks.h;
  const uint16_t* vb = v + b * vs.b + g * vs.h;

  float o[NB_O][4];
#pragma unroll
  for (int n = 0; n < NB_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + grp;
  const uint16_t* aQ = sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  const int kend = causal ? min(Tk, q0 + MMA_BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    float s[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += HDP) {
      // every warp is done with the previous chunk (and, at the first, with
      // the previous k-tile's V)
      __syncthreads();
      copy_tile<HDP, MMA_BQ>(sQ, qb + c0, qs.s, q0, S, hd - c0, w.q, tid);
      copy_tile<HDP, BK>(sK, kb + c0, ks.s, k0, Tk, hd - c0, w.k, tid);
      if (c0 == 0) copy_tile<HDP, BK>(sV, vb + oc0, vs.s, k0, Tk, hd - oc0, w.v, tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, aQ + kk * 16);
        qk_step<T, LD, BK>(s, a, sK, kk, mi, mr);
      }
    }

    const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > q0);
    uint32_t pf[PSTEPS][4];
    softmax_step<T, NB_O, BK>(s, m, l, o, pf, masked, k0, row0, Tk, causal, tig, scale_log2);
    pv_step<T, LD, NB_O, BK>(o, pf, sV, mi, mr);
  }

  store_out<T, NB_O>(out + b * os.b + h * os.h, os.s, o, l, row0, S, oc0, hd, tig, w.opair);
}

template <typename T, int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
               int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, Widths w,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = MmaTile<HDP>::SMEM;  // 87,040 B at HDP 128 (101,376 at 256): opt in
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma<T, HDP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (S + MMA_BQ - 1) / MMA_BQ;
  const long long blocks = (long long)nq * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const float log2e = 1.4426950408889634f;
  flash_fwd_mma<T, HDP><<<(unsigned)blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), nq, S, Tk, H, KV, hd, qs, ks,
      vs, os, w, scale * log2e, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma_wide(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                    int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os,
                    Widths w, float scale, int causal, cudaStream_t stream) {
  using Tile = MmaTile<WIDE_DC>;
  const size_t smem = (Tile::Q_ELEMS + 2 * Tile::KV_ELEMS) * sizeof(uint16_t);  // Q, K, V: 52,224 B
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_wide<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (S + MMA_BQ - 1) / MMA_BQ;
  const int nc = (hd + WIDE_DC - 1) / WIDE_DC;
  const long long blocks = (long long)nq * nc * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const float log2e = 1.4426950408889634f;
  flash_fwd_mma_wide<T><<<(unsigned)blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), nq, nc, S, Tk, H, KV, hd, qs,
      ks, vs, os, w, scale * log2e, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 route: flash_fwd_f32
//
// The f32 route, on the CUDA cores: every product is an f32 FMA (at most
// 67 TFLOP/s on an H100 SXM, about half of that here, since each FMA pair
// costs one shared-memory load). It serves the f32 parity checks and the
// f32 small-input serve, where TF32 would break atol 2e-5.
//
// Design: one block of 128 threads per (q-tile of BQ = 32 rows, output
// chunk, head, batch), q-tiles issued from the last (the longest causal
// row) first. The block walks the k-tiles of BK = 64 keys in order, loading
// each k and v tile into shared memory. Thread (rg, cg) = (tid / 16,
// tid % 16) owns rows rg + 8i (i < 4): it computes their scores against
// keys cg + 16j (j < 4), reduces each row's max and sum across the 16
// threads of its half-warp by shuffles, writes its p to shared memory, and
// accumulates output dims cg + 16j (j < 8) of its rows: 128 dims, one
// output chunk. Up to hd 128 there is one chunk and the q-tile is loaded
// once; above it each block owns one 128-column chunk of the output and
// walks q and k through shared memory in 128-column chunks for the scores,
// as flash_fwd_mma_wide does. Row strides are padded so that every
// shared-memory access of a warp hits distinct banks or one broadcast
// address. Elements are read one by one, so any alignment serves.
//
// Mixed dtypes take this kernel too, instantiated on v's element type TV
// and the output's TO (nine instances, <float, float> the f32 route): v is
// widened to f32 as its tile is loaded, each p is rounded to TV as it is
// written to shared memory (the denominator sums it unrounded, as the
// reference does), and the output is rounded to TO once. q and k arrive in
// f32. No model path mixes dtypes, so the route is kept simple: its
// products run at the f32 rate whatever the inputs' types.
// ---------------------------------------------------------------------------

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 64;          // keys per k-tile
constexpr int THREADS = 128;
constexpr int DC = 128;         // head-dim chunk
constexpr int QS = DC + 1;      // padded row stride of the q and k tiles
constexpr int VS = DC;          // row stride of the v tile
constexpr int PS = BK + 16;     // padded row stride of the p tile
constexpr int SMEM_FLOATS = BQ * QS + BK * QS + BK * VS + BQ * PS;

// An element type of the f32 route's v and output: widened to f32 on load,
// and a float rounded to it (to nearest, ties to even) for p and the output.
template <typename T>
struct F32Io;

template <>
struct F32Io<float> {
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct F32Io<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ float round(float x) { return widen(narrow(x)); }
};

template <>
struct F32Io<__half> {
  static __device__ __forceinline__ float widen(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half narrow(float x) { return __float2half_rn(x); }
  static __device__ __forceinline__ float round(float x) { return widen(narrow(x)); }
};

// rows r < n of a (rows, cols) operand into an f32 tile of row stride ld,
// zero past `valid` rows
template <typename T>
__device__ __forceinline__ void load_f32(float* dst, int ld, const T* src, long long stride,
                                         int n, int cols, int valid, int tid) {
  for (int i = tid; i < n * cols; i += THREADS) {
    const int r = i / cols, d = i - r * cols;
    dst[r * ld + d] = r < valid ? F32Io<T>::widen(src[(long long)r * stride + d]) : 0.f;
  }
}

// TV: v's element type, which p is rounded to before the PV product; TO:
// the output's. <float, float> is the f32 route, where both roundings are
// the identity.
template <typename TV, typename TO>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const TV* __restrict__ v, TO* __restrict__ out, int nq, int nc, int S, int Tk,
              int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * VS;

  const int tid = threadIdx.x;
  const int cg = tid & 15;
  const int rg = tid >> 4;
  const Block blk = block_of(nq, nc, H, BQ);
  const int q0 = blk.q0, h = blk.h, b = blk.b;
  const int oc0 = blk.oc * DC, ow = min(DC, hd - oc0);  // this block's output columns
  const int g = h / (H / KV);

  const float* qb = q + b * qs.b + h * qs.h + (long long)q0 * qs.s;
  const float* kb = k + b * ks.b + g * ks.h;
  const TV* vb = v + b * vs.b + g * vs.h;

  if (nc == 1) load_f32(sQ, QS, qb, qs.s, BQ, hd, S - q0, tid);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const int kn = min(BK, Tk - k0);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < hd; c0 += DC) {
      const int cw = min(DC, hd - c0);
      __syncthreads();  // the previous chunk's (and tile's) reads of sQ, sK, sV and sP are done
      if (nc > 1) load_f32(sQ, QS, qb + c0, qs.s, BQ, cw, S - q0, tid);
      load_f32(sK, QS, kb + (long long)k0 * ks.s + c0, ks.s, BK, cw, kn, tid);
      if (c0 == 0) load_f32(sV, VS, vb + (long long)k0 * vs.s + oc0, vs.s, BK, ow, kn, tid);
      __syncthreads();

#pragma unroll 8
      for (int d = 0; d < cw; ++d) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = sQ[(rg + 8 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = sK[(cg + 16 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 8 * i;
      float rmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Tk || (causal && col > row)) x = NEG;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;  // the denominator sums p unrounded
        sP[(rg + 8 * i) * PS + cg + 16 * j] = F32Io<TV>::round(p);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kn; ++c) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(rg + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = cg + 16 * j;
        if (d < ow) {
          const float vv = sV[c * VS + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
        }
      }
    }
  }

  TO* ob = out + b * os.b + h * os.h + oc0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = cg + 16 * j;
      if (d < ow) ob[(long long)row * os.s + d] = F32Io<TO>::narrow(acc[i][j] / denom);
    }
  }
}

template <typename TV, typename TO>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
               int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);  // 92,544 B: above 48 KB, so opt in
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<TV, TO>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (S + BQ - 1) / BQ;
  const int nc = (hd + DC - 1) / DC;
  const long long blocks = (long long)nq * nc * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_f32<TV, TO><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const TV*>(v),
      static_cast<TO*>(out), nq, nc, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

// The f32 route with v of dtype `vd` and the output of dtype `od` (0 = f32,
// 1 = bf16, 2 = f16): one of the nine instances.
template <typename TV>
int launch_f32_out(int od, const void* q, const void* k, const void* v, void* out, int B, int S,
                   int Tk, int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, int causal, cudaStream_t s) {
  if (od == 0)
    return launch_f32<TV, float>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  if (od == 1)
    return launch_f32<TV, __nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale,
                                         causal, s);
  if (od == 2)
    return launch_f32<TV, __half>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The widest copy (16, 8 or 4 bytes, else 2) that keeps every row chunk of
// a 2-byte operand aligned: the base, the strides and the row's hd
// elements all multiples of it.
int copy_width(const void* p, Strides s, int hd) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int w = 16; w > 2; w /= 2)
    if (a % w == 0 && (2 * s.b) % w == 0 && (2 * s.s) % w == 0 && (2 * s.h) % w == 0 &&
        (2 * hd) % w == 0)
      return w;
  return 2;
}

template <typename T>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
              int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
              int causal, cudaStream_t s) {
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const Widths w{copy_width(q, qs, hd), copy_width(k, ks, hd), copy_width(v, vs, hd),
                 oa % 4 == 0 && os.b % 2 == 0 && os.s % 2 == 0 && os.h % 2 == 0};
  if (hd <= 32)
    return launch_mma<T, 32>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w, scale, causal, s);
  if (hd <= 64)
    return launch_mma<T, 64>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w, scale, causal, s);
  if (hd <= 128)
    return launch_mma<T, 128>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w, scale, causal, s);
  if (hd <= 256)
    return launch_mma<T, 256>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w, scale, causal, s);
  return launch_mma_wide<T>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w, scale, causal, s);
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all on the
// device, of dtype 0 = f32, 1 = bf16 or 2 = f16, with B, S, T, H, KV,
// hd >= 1 and H % KV == 0 (the wrapper checks), any alignment, and unit
// stride along hd. Strides are in elements for the batch, sequence and head
// axes. Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int S, int Tk, int H, int KV, int hd,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   long long osb, long long oss, long long osh,
                                   float scale, int causal, void* stream) {
  if (B < 1 || S < 1 || Tk < 1 || H < 1 || KV < 1 || hd < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32<float, float>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale,
                                    causal, s);
  if (dtype == 1)
    return launch_tc<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale,
                                    causal, s);
  if (dtype == 2)
    return launch_tc<__half>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// q and k of mixed dtypes, widened to f32 by the caller: q (B, S, H, hd)
// and k (B, T, KV, hd) f32, v (B, T, KV, hd) of dtype `vdtype`, out
// (B, S, H, hd) of dtype `odtype` (q's before the widening), each 0 = f32,
// 1 = bf16 or 2 = f16; the rest as flash_attention_fwd. p is rounded to v's
// dtype before the PV product.
extern "C" int flash_attention_fwd_mixed(const void* q, const void* k, const void* v, void* out,
                                         int vdtype, int odtype, int B, int S, int Tk, int H,
                                         int KV, int hd, long long qsb, long long qss,
                                         long long qsh, long long ksb, long long kss,
                                         long long ksh, long long vsb, long long vss,
                                         long long vsh, long long osb, long long oss,
                                         long long osh, float scale, int causal, void* stream) {
  if (B < 1 || S < 1 || Tk < 1 || H < 1 || KV < 1 || hd < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vdtype == 0)
    return launch_f32_out<float>(odtype, q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale,
                                 causal, s);
  if (vdtype == 1)
    return launch_f32_out<__nv_bfloat16>(odtype, q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os,
                                         scale, causal, s);
  if (vdtype == 2)
    return launch_f32_out<__half>(odtype, q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale,
                                  causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
