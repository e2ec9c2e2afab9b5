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
// Routes, chosen by dtype and head dim alone in the two entry points at
// the end:
//   - bf16 and f16, 32 < hd <= 128, every model path's head dim:
//     `flash_fwd_wgmma<T, HDP, NWG>`, on Hopper's own instructions (wgmma,
//     TMA, an mbarrier ring), hd padded to HDP = 64 or 128;
//   - bf16 and f16, hd <= 32 and 128 < hd <= 256: `flash_fwd_mma<T, HDP>`,
//     on the tensor cores by mma.sync m16n8k16, hd padded to HDP = 32 or
//     256; no model path reaches them;
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
// no limit below 2³¹ blocks. The wgmma route walks items of
// (q-tile, head, batch) on a persistent grid instead.
//
// The wgmma route, flash_fwd_wgmma<T, HDP, NWG> (its section below). What
// bounds it on an H100 SXM (989 TFLOP/s bf16 and f16, 3.35 TB/s), causal,
// 2·B·H·S·T·hd FLOP against q, k, v and the output moved once:
//   (4, 1,000, 12, 2, 128)   qwen2 serve prefill  12.3 GFLOP  0.0124 ms (operations)
//   (4, 1,000, 16, 16, 128)  qwen2-moe prefill    65.5 MB     0.0196 ms (bytes)
//   (4, 1,024, 16, 8, 128)   qwen3 train step     17.2 GFLOP  0.0174 ms (operations)
//   (4, 1,000, 12, 12, 64)   whisper prefill      24.6 MB     0.0073 ms (bytes)
// The mma.sync kernel it replaces on these head dims lost to three things,
// and each part of this design answers one:
// - Every warp re-read the whole K and V tiles from shared memory for its
//   own 16 rows (ldmatrix), 16 FLOP a byte, half the tensor cores' rate.
//   Here a consumer warpgroup of 64 rows runs S = Q Kᵀ and O += P V as
//   wgmma.mma_async m64nNk16, which reads its B tile from shared memory
//   once for all 64 rows and issues no ldmatrix: Q and K by K-major
//   descriptors, V (key, dim) by an MN-major descriptor with the transpose
//   bit, P from a per-warpgroup tile in shared memory that each tile's
//   softmax writes by stmatrix. All tiles are in the 128-byte swizzle that
//   TMA writes and the descriptors read. (P from registers, wgmma's RS
//   form, needs S, O and P live at once, 160 registers beside the rest:
//   within the 168 a thread that __launch_bounds__(384, 1) gives, ptxas
//   spills and serializes the products. setmaxnreg did not lift that
//   limit, and with P in shared memory the consumers fit in 168, so the
//   kernel issues none.)
// - One k-tile was in flight, behind a block-wide barrier per tile. Here
//   a producer warp keeps a ring of K and V stages (128 keys; 2 stages at
//   HDP 128, 3 at 64) full by TMA (cp.async.bulk.tensor from 4-d tensor
//   maps built per call), each stage's K and V under a full and an empty
//   mbarrier of their own, so K of tile j + 2 loads as soon as tile j's
//   S is done. TMA's zero fill past S, T and hd replaces the masked tails'
//   copies. Within a warpgroup tile j's S is issued beside tile j - 1's PV,
//   so the softmax runs under PV; the two consumer warpgroups take turns to
//   issue (pingpong, named barriers), so one's softmax runs under the
//   other's products.
// - Blocks were 4 warps and 64 rows, two an SM. Here a block is one
//   producer and NWG = 2 consumer warpgroups (128 rows), one an SM,
//   persistent: 132 blocks walk the (128-row q-tile, head, batch) items,
//   longest causal rows first, in a snake order that evens out the blocks'
//   work; Q is double-buffered so that an item's Q lands while the last one
//   runs, and the output leaves through shared memory in 16-byte stores.
//   Grids smaller than the card take 64-row items (NWG = 1). A row's
//   output depends on its own warpgroup's 64 rows and the fixed k-tile
//   order alone, not on NWG or the block: the two give the same bits.
// An operand TMA cannot read (a base or a row, head or batch stride that is
// not a multiple of 16 bytes, such as views with a sequence stride of 68)
// is copied by the producer warpgroup with cp.async of 16, 8 or 4 bytes (or
// 2-byte loads) into the same swizzled stage: the products, and so the
// output, do not depend on the copy path.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
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
  int q, k, v, opair, o16;
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
// bf16 and f16 at hd <= 32 and hd > 128: flash_fwd_mma and
// flash_fwd_mma_wide
//
// Ampere's instruction set, FlashAttention-2's shape, for the head dims no
// model path reaches (the model paths' 32 < hd <= 128 take flash_fwd_wgmma
// below). Like every route it is bound by tensor-core operations at the
// serve batch and prompt. The design:
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
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;  // query rows per block, 16 per warp
constexpr int MMA_THREADS = 128;
constexpr int WIDE_DC = 128;  // head-dim chunk of flash_fwd_mma_wide

// The tiles of a padded head dim HDP: 64 query rows, and k-tiles of BK keys,
// 64 up to HDP 128 (HDP 128 is flash_fwd_mma_wide's chunk) and 32 at 256,
// where a warp's 16 × 256 f32 accumulator leaves no room for 64 keys'
// scores and P fragments beside it (with 64, ptxas spills at 255
// registers). Blocks an SM: 4 at HDP 32, 2 at 256, so that each keeps its
// registers within 65,536 / (blocks · 128).
template <int HDP>
struct MmaTile {
  static constexpr int BK = HDP > 128 ? 32 : 64;  // keys per k-tile
  static constexpr int LD = HDP + 8;              // row stride in elements
  static constexpr int Q_ELEMS = MMA_BQ * LD;     // the q-tile
  static constexpr int KV_ELEMS = BK * LD;        // one k-tile of K or of V
  static constexpr size_t SMEM = (Q_ELEMS + 4 * KV_ELEMS) * sizeof(uint16_t);  // Q + 2 × (K, V)
  static constexpr int BLOCKS = HDP == 32 ? 4 : 2;
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
  static constexpr bool BF16 = true;
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
  static constexpr bool BF16 = false;
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
// bf16 and f16 at 32 < hd <= 128: flash_fwd_wgmma<T, HDP, NWG>
//
// Hopper's own instructions; the design and what bounds it are in the
// header. A producer warpgroup fills a ring of K and V stages by TMA, or by
// cp.async where TMA cannot read the operand; NWG consumer warpgroups of 64
// query rows each run S = QKᵀ and O += PV on wgmma and the online softmax
// on the accumulator registers.
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 128;  // a warpgroup
constexpr int WG_ROWS = 64;      // query rows a consumer warpgroup: wgmma's M

// The tiles of a padded head dim HDP (64 or 128). Every tile is stored as
// HDP / 64 column halves of 128-byte rows in the 128-byte swizzle (16-byte
// chunk c of row r at chunk c ^ (r % 8)), the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma's descriptors read; each half and
// each tile starts on a 1,024-byte boundary, the swizzle's period.
template <int HDP>
struct WgTile {
  static constexpr int BK = 128;                      // keys a k-tile: S's N
  static constexpr int STAGES = HDP == 64 ? 3 : 2;    // K and V stages in the ring
  static constexpr int HALVES = HDP / 64;             // 64-column swizzle atoms a row
  static constexpr int HALF_Q = WG_ROWS * 128;        // bytes of one half of a Q tile
  static constexpr int HALF_KV = BK * 128;            // ... of a K or V tile
  static constexpr int Q_BYTES = HALVES * HALF_Q;     // a consumer warpgroup's Q tile
  static constexpr int KV_BYTES = HALVES * HALF_KV;   // one k-tile of K or of V
  static constexpr int HALF_P = WG_ROWS * 128;        // one half of a P tile (64 keys)
  static constexpr int P_BYTES = (BK / 64) * HALF_P;  // a consumer warpgroup's P tile
  // two Q buffers of NWG tiles, K stages, V stages, NWG P tiles, then the
  // barriers, from a base rounded up to 1,024 bytes: 230,496 B at HDP 128
  // with two consumers (of 232,448), one block an SM
  static constexpr size_t smem(int nwg) {
    return 1024 + (size_t)nwg * (2 * Q_BYTES + P_BYTES) + 2 * STAGES * KV_BYTES +
           8 * (4 * STAGES + 4);
  }
};

// Registers and barriers --------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// an arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// this thread's writes to shared memory made visible to the async proxy
// (wgmma's reads), as cp.async and st.shared write through the generic one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a TMA load of the box at (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void cp_async16_at(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8_at(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4_at(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// every cp.async this thread has issued, committed or not, has landed
__device__ __forceinline__ void cp_async_drain() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t dst, uint16_t x) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
}

// The copy path for an operand TMA cannot read (a base or a row, head or
// batch stride that is not a multiple of 16 bytes): rows row0 .. row0 +
// ROWS - 1 of a (rows, hd) operand into the same swizzled tile TMA would
// write, ROWS / BUF_ROWS buffers of BUF_ROWS rows, each buffer HDP / 64
// halves; rows >= nrows and columns >= hd zero, as TMA fills them. `width`
// is the bytes of each copy (16, 8, 4 or 2), which the base, the strides
// and hd allow; the 128 producer threads share the copies.
template <int HDP, int ROWS, int BUF_ROWS>
__device__ __forceinline__ void copy_swizzled(uint32_t dst, const uint16_t* src,
                                              long long row_stride, int row0, int nrows, int hd,
                                              int width, int t) {
  constexpr int HALF = BUF_ROWS * 128;
  constexpr int BUF = (HDP / 64) * HALF;
  const int per = width / 2;  // elements a copy
  const int cpr = HDP / per;  // copies a row
  for (int idx = t; idx < ROWS * cpr; idx += WG_THREADS) {
    const int r = idx / cpr, e = (idx - r * cpr) * per;
    const bool in = row0 + r < nrows && e < hd;
    const uint16_t* g = in ? src + (long long)(row0 + r) * row_stride + e : src;
    const int rb = r % BUF_ROWS;
    const uint32_t d = dst + (r / BUF_ROWS) * BUF + (e / 64) * HALF + rb * 128 +
                       ((((e % 64) >> 3) ^ (rb & 7)) << 4) + (e % 8) * 2;
    if (width == 16)
      cp_async16_at(d, g, in);
    else if (width == 8)
      cp_async8_at(d, g, in);
    else if (width == 4)
      cp_async4_at(d, g, in);
    else
      st_shared_u16(d, in ? *g : uint16_t(0));
  }
}

// wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor in the 128-byte swizzle: the start
// address, the leading and stride byte offsets (each in 16-byte units) and
// layout type 1 (SWIZZLE_128B) in bits 62-63. K-major tiles (Q and K: the
// product's K, the head dim, contiguous) step 1,024 bytes from one 8-row
// group to the next (SBO); their LBO is unused (1). The MN-major V tile
// (keys × head dim, read with the transpose bit) steps 1,024 bytes from one
// 8-key group to the next (SBO) and HALF_KV bytes from one 64-column half
// of the head dim to the next (LBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma reads or writes, held in place: the
// compiler may not move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16 with f32 accumulators, A and B by descriptors
// from shared memory: A K-major; B K-major (TB "0") or MN-major, read with
// the transpose bit (TB "1"). scale_d = 0 overwrites D.
#define WGMMA_SS_N64(AB, TB)                                                               \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                             \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {"                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"         \
  "}, %32, %33, p, 1, 1, 0, " TB ";\n}\n"

#define WGMMA_SS_N128(AB, TB)                                                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                             \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {"                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"         \
  "}, %64, %65, p, 1, 1, 0, " TB ";\n}\n"

#define ACC8(d, i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),              \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d, i) ACC8(d, i), ACC8(d, i + 8), ACC8(d, i + 16), ACC8(d, i + 24)

template <typename T, int N>
struct Wgmma;

#define DEFINE_WGMMA(TYPE, AB)                                                             \
  template <>                                                                              \
  struct Wgmma<TYPE, 64> {                                                                 \
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,      \
                                              int scale_d) {                               \
      asm volatile(WGMMA_SS_N64(AB, "0") : ACC32(d, 0) : "l"(a), "l"(b), "r"(scale_d));    \
    }                                                                                      \
    static __device__ __forceinline__ void ss_bt(float (&d)[32], uint64_t a, uint64_t b,   \
                                                 int scale_d) {                            \
      asm volatile(WGMMA_SS_N64(AB, "1") : ACC32(d, 0) : "l"(a), "l"(b), "r"(scale_d));    \
    }                                                                                      \
  };                                                                                       \
  template <>                                                                              \
  struct Wgmma<TYPE, 128> {                                                                \
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,      \
                                              int scale_d) {                               \
      asm volatile(WGMMA_SS_N128(AB, "0")                                                  \
                   : ACC32(d, 0), ACC32(d, 32)                                             \
                   : "l"(a), "l"(b), "r"(scale_d));                                        \
    }                                                                                      \
    static __device__ __forceinline__ void ss_bt(float (&d)[64], uint64_t a, uint64_t b,   \
                                                 int scale_d) {                            \
      asm volatile(WGMMA_SS_N128(AB, "1")                                                  \
                   : ACC32(d, 0), ACC32(d, 32)                                             \
                   : "l"(a), "l"(b), "r"(scale_d));                                        \
    }                                                                                      \
  };

DEFINE_WGMMA(__nv_bfloat16, "bf16")
DEFINE_WGMMA(__half, "f16")

// The kernel ----------------------------------------------------------------

// 2^x by the SFU's ex2.approx.ftz: 2^(NEG - m) is +0, as the mask needs
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale, mask and the online softmax on one k-tile's S accumulators (the
// m64nBK layout: element 4n + e of a thread is row grp + 8·(e / 2) of its
// warp's 16, key 8n + 2·tig + e % 2 of the tile): the running max m moves
// to the tile's, s becomes p = 2^(s·scale - m) unrounded, l becomes
// l·α + Σ p, and α = 2^(m_old - m_new) is returned for O's rescale, which
// waits for the PV product in flight. Every rounding is explicit
// (__fmul_rn, __fmaf_rn), so no instance contracts differently.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int k0, int row0,
                                             int Tk, int causal, int tig, float scale_log2) {
  float tmax[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (masked) {
      const int col = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (col >= Tk || (causal && col > row)) s[i] = NEG;
    }
    tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);
    alpha[r] = exp2_approx(__fmul_rn(__fsub_rn(m[r], m_new), scale_log2));
    m[r] = m_new;
    mc[r] = -__fmul_rn(m_new, scale_log2);
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = exp2_approx(__fmaf_rn(s[i], scale_log2, mc[(i >> 1) & 1]));
    psum[(i >> 1) & 1] = __fadd_rn(psum[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], psum[r]);
}

// A warp's 16 rows × N columns of an m64nN accumulator (P, or O at the
// end), rounded to T, into a K-major tile in the 128-byte swizzle (rows of
// 64 columns, 128 bytes; column halves HALF bytes apart): one stmatrix.x4
// for each two 8-column blocks, its 8×8 matrices the two blocks' rows 0-7
// and 8-15, each matrix row one 16-byte chunk. Lane L gives the address of
// row L % 8 of matrix L / 8. SCALED divides each value by its row's `den`
// first (the output's max(l, 1e-30)).
template <typename T, int N, bool SCALED>
__device__ __forceinline__ void stmatrix_tile(uint32_t base, int half, const float (&d)[N / 2],
                                              const float (&den)[2], int warp, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
  const int row = warp * 16 + (mat & 1) * 8 + mrow;
#pragma unroll
  for (int n = 0; n < N / 8; n += 2) {
    const int blk = n + (mat >> 1);  // this lane's matrix's 8-column block
    const uint32_t at = base + (blk / 8) * half + row * 128 + (((blk % 8) ^ (row & 7)) << 4);
    uint32_t r[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = 4 * (n + (m >> 1)) + 2 * (m & 1);  // block n + m / 2, rows + 8·(m % 2)
      r[m] = SCALED ? Elem<T>::pack(__fdiv_rn(d[i], den[m & 1]), __fdiv_rn(d[i + 1], den[m & 1]))
                    : Elem<T>::pack(d[i], d[i + 1]);
    }
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                 "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
  }
}

// The output's divisors of the thread's two rows: each row's denominator
// (the sum over its quad, in one fixed order) as max(l, 1e-30). O is
// divided by it in IEEE division, as the reference divides.
__device__ __forceinline__ void row_dens(float (&l)[2], float (&den)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
    den[r] = fmaxf(l[r], 1e-30f);
  }
}

// The register path of the output, where 16-byte stores do not fit it:
// the warpgroup's rows of O over their divisors, written as T, columns
// 8n + 2·tig (+1) below hd, two a 4-byte store where `pair` allows it.
template <typename T, int HDP>
__device__ __forceinline__ void store_rows(uint16_t* ob, long long row_stride, const float (&o)[HDP / 2],
                                           const float (&den)[2], int row0, int S, int hd, int tig,
                                           int pair) {
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    const int col = n * 8 + 2 * tig;
    if (col >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= S) continue;
      const uint32_t two = Elem<T>::pack(__fdiv_rn(o[4 * n + 2 * r], den[r]),
                                         __fdiv_rn(o[4 * n + 2 * r + 1], den[r]));
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

// The k-tiles a consumer warpgroup whose first row is r0 reads, in order
// from key 0: causal rows stop at the tile that holds their diagonal, so
// the count depends on the warpgroup's 64 rows and not on the block.
__device__ __forceinline__ int wg_tiles(int r0, int S, int Tk, int causal, int bk) {
  if (r0 >= S) return 0;
  const int kend = causal ? min(Tk, r0 + WG_ROWS) : Tk;
  return (kend + bk - 1) / bk;
}

// The ring's barriers, 8 bytes each after the tiles: for each stage s a
// full and an empty barrier for its K tile and for its V tile, then a full
// and an empty barrier for each of the two Q buffers.
struct Ring {
  uint32_t base;
  int stages;
  __device__ __forceinline__ uint32_t full_k(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t full_v(int s) const { return base + 8 * (stages + s); }
  __device__ __forceinline__ uint32_t empty_k(int s) const { return base + 8 * (2 * stages + s); }
  __device__ __forceinline__ uint32_t empty_v(int s) const { return base + 8 * (3 * stages + s); }
  __device__ __forceinline__ uint32_t q_full(int i) const { return base + 8 * (4 * stages + i); }
  __device__ __forceinline__ uint32_t q_empty(int i) const { return base + 8 * (4 * stages + 2 + i); }
};

// One k-tile of K or V (BK rows from k0) into a stage, by TMA or by the copy
// path, and its full barrier's arrivals: thread 0's with the TMA bytes,
// and on the copy path each producer thread's once its copies have landed.
template <int HDP>
__device__ __forceinline__ void load_kv(uint32_t dst, uint32_t full, const CUtensorMap* map,
                                        const uint16_t* src, long long row_stride, int width,
                                        int k0, int g, int b, int Tk, int hd, int t) {
  using Tile = WgTile<HDP>;
  if (t == 0) {
    mbar_arrive_tx(full, width ? 0 : Tile::KV_BYTES);
    if (!width)
      for (int hf = 0; hf < Tile::HALVES; ++hf)
        tma_load_4d(dst + hf * Tile::HALF_KV, map, full, hf * 64, k0, g, b);
  }
  if (width) {
    copy_swizzled<HDP, Tile::BK, Tile::BK>(dst, src, row_stride, k0, Tk, hd, width, t);
    cp_async_drain();
    fence_proxy_async();
    mbar_arrive(full);
  }
}

// A work item: a block of NWG · 64 query rows of one (head, batch). Items
// are numbered longest causal rows first (the q-tile slowest), and block i
// of the G resident ones takes items i, 2G - 1 - i, 2G + i, ... (a snake, so
// that the long and short ones even out).
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ int item_id(int round, int G) {
  return round * G + ((round & 1) ? G - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

__device__ __forceinline__ Item item_of(int id, int nq, int H, int B, int rows) {
  const int hb = id % (H * B);
  return {(nq - 1 - id / (H * B)) * rows, hb % H, hb / H};
}

// Widths: for each of q, k and v, 0 where TMA reads it through its tensor
// map, else the bytes of each cp.async copy (16, 8, 4 or 2); `opair` as in
// the mma kernels; `o16`: the output takes 16-byte stores of 8 columns.
template <typename T, int HDP, int NWG>
__global__ void __launch_bounds__((NWG + 1) * WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const uint16_t* __restrict__ q,
                const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
                uint16_t* __restrict__ out, int nq, int items, int S, int Tk, int B, int H,
                int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, Widths w,
                float scale_log2, int causal) {
  using Tile = WgTile<HDP>;
  constexpr int BK = Tile::BK;
  constexpr int STAGES = Tile::STAGES;
  constexpr int ROWS = NWG * WG_ROWS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + 2 * NWG * Tile::Q_BYTES;  // after two Q buffers: STAGES k-tiles of K
  const uint32_t sV = sK + STAGES * Tile::KV_BYTES;  // STAGES k-tiles of V
  const uint32_t sP = sV + STAGES * Tile::KV_BYTES;  // each consumer's P tile
  const Ring ring{sP + NWG * Tile::P_BYTES, STAGES};
  const int G = gridDim.x;
  // the warpgroup, made visibly warp-uniform (a shuffle of lane 0)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int t = threadIdx.x % WG_THREADS;
  // an item's k-tiles: those of its last warpgroup that holds a real row
  auto block_tiles = [&](int q0) {
    return wg_tiles(q0 + min(NWG - 1, (S - 1 - q0) / WG_ROWS) * WG_ROWS, S, Tk, causal, BK);
  };

  if (threadIdx.x == 0) {
    // a full barrier: thread 0's arrival with the TMA bytes, and where the
    // copy path loads the operand, each producer thread's once its copies
    // have landed; an empty one: each consumer warp's
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.full_k(s), w.k ? WG_THREADS + 1 : 1);
      mbar_init(ring.full_v(s), w.v ? WG_THREADS + 1 : 1);
      mbar_init(ring.empty_k(s), 4 * NWG);
      mbar_init(ring.empty_v(s), 4 * NWG);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ring.q_full(i), w.q ? WG_THREADS + 1 : 1);
      mbar_init(ring.q_empty(i), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: for each item, its Q once the consumers are done with
    // the last item's, then its K and V tile by tile into the ring, each
    // stage refilled once every consumer warp has released it. The ring
    // runs on across items: `it` counts the tiles loaded.
    // where TMA reads all three, one warp does the producer's work and the
    // other three leave, so as not to take the consumers' issue slots
    if ((w.q | w.k | w.v) == 0 && t >= 32) return;
    int it = 0;
    for (int round = 0;; ++round) {
      const int id = item_id(round, G);
      if (id >= items) break;
      const Item itm = item_of(id, nq, H, B, ROWS);
      const int g = itm.h / (H / KV);
      // Q into buffer round % 2 once the consumers are done with the item
      // two rounds back, so that an item's Q lands while the last one runs
      const int qb = round & 1;
      const uint32_t dQ = sQ + qb * NWG * Tile::Q_BYTES;
      if (round > 1) mbar_wait(ring.q_empty(qb), ((round >> 1) - 1) & 1);
      if (t == 0) {
        mbar_arrive_tx(ring.q_full(qb), w.q ? 0 : NWG * Tile::Q_BYTES);
        if (!w.q)
          for (int c = 0; c < NWG; ++c)
            for (int hf = 0; hf < Tile::HALVES; ++hf)
              tma_load_4d(dQ + c * Tile::Q_BYTES + hf * Tile::HALF_Q, &tq, ring.q_full(qb), hf * 64,
                          itm.q0 + c * WG_ROWS, itm.h, itm.b);
      }
      if (w.q) {
        copy_swizzled<HDP, ROWS, WG_ROWS>(dQ, q + itm.b * qs.b + itm.h * qs.h, qs.s, itm.q0, S, hd,
                                          w.q, t);
        cp_async_drain();
        fence_proxy_async();
        mbar_arrive(ring.q_full(qb));
      }
      const uint16_t* kb = k + itm.b * ks.b + g * ks.h;
      const uint16_t* vb = v + itm.b * vs.b + g * vs.h;
      const int ntiles = block_tiles(itm.q0);
      for (int j = 0; j < ntiles; ++j, ++it) {
        const int st = it % STAGES;
        const uint32_t parity = ((it / STAGES) - 1) & 1;  // of the release of tile it - STAGES
        if (it >= STAGES) mbar_wait(ring.empty_k(st), parity);
        load_kv<HDP>(sK + st * Tile::KV_BYTES, ring.full_k(st), &tk, kb, ks.s, w.k, j * BK, g,
                     itm.b, Tk, hd, t);
        if (it >= STAGES) mbar_wait(ring.empty_v(st), parity);
        load_kv<HDP>(sV + st * Tile::KV_BYTES, ring.full_v(st), &tv, vb, vs.s, w.v, j * BK, g,
                     itm.b, Tk, hd, t);
      }
    }
    return;
  }

  // A consumer: 64 query rows of each item, 16 a warp. Tile j's S = Q K_j
  // is issued beside tile j - 1's O += P V_{j-1}, so that tile j's softmax
  // runs while the tensor cores do PV; the order of every sum is that of
  // the loop written without the overlap. With two consumers they take
  // turns to issue (pingpong), so that one's softmax runs under the other's
  // products.
  const int c = wg - 1;
  const int lane = t & 31, warp = t >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const uint32_t aP = sP + c * Tile::P_BYTES;
  uint32_t aQ = 0;  // this consumer's Q tile in the round's buffer

  float o[HDP / 2];
  float m[2], l[2];   // running max and this thread's part of the denominators of its 2 rows
  float s[BK / 2];    // S, then P unrounded
  float alpha[2];

  // Named barriers: 1 + c is this consumer's turn to issue, which the other
  // grants (bar.arrive); 3 + c gathers its 128 threads once P is stored.
  // Each consumer takes ntiles + 1 turns an item; the first absorbs the
  // second's last grant at the end.
  auto turn = [&]() {
    if constexpr (NWG == 2) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
  };
  auto grant = [&]() {
    if constexpr (NWG == 2) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - c) : "memory");
  };
  // S = Q K_j: 64 rows × BK keys over the head dim, 16 columns a step
  auto issue_qk = [&](int st) {
    const uint32_t aK = sK + st * Tile::KV_BYTES;
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 columns of a 128-byte swizzled row
      Wgmma<T, BK>::ss(s, smem_desc(aQ + (kk / 4) * Tile::HALF_Q + off, 16, 1024),
                       smem_desc(aK + (kk / 4) * Tile::HALF_KV + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V_j: 16 keys a step, P K-major, V read (key, dim) with the
  // transpose bit
  auto issue_pv = [&](int st) {
    const uint32_t aV = sV + st * Tile::KV_BYTES;
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<T, HDP>::ss_bt(o, smem_desc(aP + (kk / 4) * Tile::HALF_P + (kk % 4) * 32, 16, 1024),
                           smem_desc(aV + kk * 16 * 128, Tile::HALF_KV, 1024), 1);
    wgmma_commit();
  };
  // P_j into shared memory, visible to the next PV of every warp
  const float one[2] = {1.f, 1.f};  // P is stored unscaled: not read
  auto publish_p = [&]() {
    stmatrix_tile<T, BK, false>(aP, Tile::HALF_P, s, one, warp, lane);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
  };
  auto release = [&](uint32_t bar) {
    if (lane == 0) mbar_arrive(bar);
  };

  if constexpr (NWG == 2)
    if (c == 1) grant();  // the first turn is c = 0's
  int it = 0;
  for (int round = 0;; ++round) {
    const int id = item_id(round, G);
    if (id >= items) break;
    const Item itm = item_of(id, nq, H, B, ROWS);
    const int ntiles = block_tiles(itm.q0);
    const int r0 = itm.q0 + c * WG_ROWS;
    const int mine = wg_tiles(r0, S, Tk, causal, BK);
    const int row0 = r0 + warp * 16 + grp;  // and row0 + 8
    auto softmax = [&](int j) {
      const int k0 = j * BK;
      const bool masked = k0 + BK > Tk || (causal && k0 + BK - 1 > r0);
      softmax_tile<BK>(s, m, l, alpha, masked, k0, row0, Tk, causal, tig, scale_log2);
    };
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
    const int qb = round & 1;
    aQ = sQ + (qb * NWG + c) * Tile::Q_BYTES;
    mbar_wait(ring.q_full(qb), (round >> 1) & 1);
    if (mine > 0) {
      mbar_wait(ring.full_k(it % STAGES), (it / STAGES) & 1);
      turn();
      issue_qk(it % STAGES);
      grant();
      wgmma_wait<0>();
      hold(s);
      release(ring.empty_k(it % STAGES));
      if (mine == 1) release(ring.q_empty(qb));
      softmax(0);  // O is 0: no rescale
      publish_p();
      for (int j = 1; j < mine; ++j) {
        const int cur = it + j, prev = cur - 1;
        mbar_wait(ring.full_k(cur % STAGES), (cur / STAGES) & 1);
        mbar_wait(ring.full_v(prev % STAGES), (prev / STAGES) & 1);
        turn();
        issue_qk(cur % STAGES);
        issue_pv(prev % STAGES);
        grant();
        wgmma_wait<1>();  // S_j is done; PV_{j-1} may still run
        hold(s);
        release(ring.empty_k(cur % STAGES));
        if (j == mine - 1) release(ring.q_empty(qb));
        softmax(j);
        wgmma_wait<0>();
        hold(o);
        release(ring.empty_v(prev % STAGES));
        // α = 1 exactly where a row's max stayed: O·1 is O, so a warp whose
        // rows all kept theirs skips the rescale
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < HDP / 2; ++i) o[i] = __fmul_rn(o[i], alpha[(i >> 1) & 1]);
        }
        publish_p();
      }
      const int lst = it + mine - 1;
      mbar_wait(ring.full_v(lst % STAGES), (lst / STAGES) & 1);
      turn();
      issue_pv(lst % STAGES);
      grant();
      wgmma_wait<0>();
      hold(o);
      release(ring.empty_v(lst % STAGES));
    } else {
      release(ring.q_empty(qb));
      turn();
      grant();
    }
    // the tiles the item loads past this warpgroup's diagonal: released
    // unread, in order, so that every stage's phases stay in step
    for (int j = mine; j < ntiles; ++j) {
      const int cur = it + j;
      turn();
      grant();
      mbar_wait(ring.full_k(cur % STAGES), (cur / STAGES) & 1);
      release(ring.empty_k(cur % STAGES));
      mbar_wait(ring.full_v(cur % STAGES), (cur / STAGES) & 1);
      release(ring.empty_v(cur % STAGES));
    }
    it += ntiles;
    if (mine > 0) {
      uint16_t* ob = out + itm.b * os.b + itm.h * os.h;
      float den[2];
      row_dens(l, den);
      if (w.o16) {
        // O through the P tile, which the last PV has done with, so that
        // each row leaves in 16-byte stores of whole 128-byte lines
        stmatrix_tile<T, HDP, true>(aP, Tile::HALF_P, o, den, warp, lane);
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
        for (int idx = t; idx < WG_ROWS * (HDP / 8); idx += WG_THREADS) {
          const int row = idx / (HDP / 8), ch = idx % (HDP / 8);
          if (r0 + row >= S || ch * 8 >= hd) continue;
          uint32_t x0, x1, x2, x3;
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
                       : "r"(aP + (ch / 8) * Tile::HALF_P + row * 128 +
                             (((ch % 8) ^ (row & 7)) << 4)));
          asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                           ob + (long long)(r0 + row) * os.s + ch * 8),
                       "r"(x0), "r"(x1), "r"(x2), "r"(x3)
                       : "memory");
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");  // the P tile is free again
      } else {
        store_rows<T, HDP>(ob, os.s, o, den, row0, S, hd, tig, w.opair);
      }
    }
  }
  if constexpr (NWG == 2)
    if (c == 0) turn();  // the second consumer's last grant
}

// Host side -----------------------------------------------------------------

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

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// links the runtime alone; null where the driver has no such entry point
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return EncodeTiled(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Whether TMA reads a 2-byte operand of `rows` rows, `heads` heads and
// `batch` batches: a 16-byte-aligned base, and every stride of an axis
// longer than 1 a non-zero multiple of 16 bytes.
bool tma_reads(const void* p, Strides s, int rows, int heads, int batch) {
  auto ok = [](long long st, int n) { return n == 1 || (st > 0 && (2 * st) % 16 == 0); };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ok(s.s, rows) && ok(s.h, heads) &&
         ok(s.b, batch);
}

// The 4-d (hd, rows, heads, batch) tensor map of an operand TMA reads,
// boxes of 64 columns × box_rows rows in the 128-byte swizzle, zero past
// every edge. An axis of size 1 (whose stride the wrapper passes as 0) gets
// the stride of a packed layout, which is never used.
int encode_map(CUtensorMap* map, const void* p, CUtensorMapDataType dt, int hd, int rows,
               int heads, int batch, Strides s, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row = rows > 1 ? 2 * s.s : 16 * (((cuuint64_t)hd * 2 + 15) / 16);
  const cuuint64_t head = heads > 1 ? 2 * s.h : row * rows;
  const cuuint64_t bat = batch > 1 ? 2 * s.b : head * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row, head, bat};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, dt, 4, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int HDP, int NWG>
int launch_wgmma_rows(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                      int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os,
                      Widths w, float scale, int causal, int sms, cudaStream_t stream) {
  const size_t smem = WgTile<HDP>::smem(NWG);
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<T, HDP, NWG>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nq = (S + NWG * WG_ROWS - 1) / (NWG * WG_ROWS);
  const long long items = (long long)nq * H * B;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);  // one resident block an SM
  const float log2e = 1.4426950408889634f;
  flash_fwd_wgmma<T, HDP, NWG><<<grid, (NWG + 1) * WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), nq, (int)items, S, Tk, B, H,
      KV, hd, qs, ks, vs, os, w, scale * log2e, causal);
  return (int)cudaGetLastError();
}

template <typename T, int HDP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                 int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, int opair,
                 float scale, int causal, cudaStream_t stream) {
  const CUtensorMapDataType dt =
      Elem<T>::BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq{}, tk{}, tv{};  // an operand TMA does not read keeps a zero map
  const bool o16 = reinterpret_cast<uintptr_t>(out) % 16 == 0 && (2 * os.s) % 16 == 0 &&
                   (2 * os.h) % 16 == 0 && (2 * os.b) % 16 == 0 && hd % 8 == 0;
  Widths w{0, 0, 0, opair, o16};
  struct Operand {
    CUtensorMap* map;
    const void* p;
    Strides s;
    int rows, heads, box;
    int* width;
  } ops[3] = {{&tq, q, qs, S, H, WG_ROWS, &w.q},
              {&tk, k, ks, Tk, KV, WgTile<HDP>::BK, &w.k},
              {&tv, v, vs, Tk, KV, WgTile<HDP>::BK, &w.v}};
  for (const Operand& a : ops) {
    if (tma_reads(a.p, a.s, a.rows, a.heads, B)) {
      const int err = encode_map(a.map, a.p, dt, hd, a.rows, a.heads, B, a.s, a.box);
      if (err) return err;
    } else {
      *a.width = copy_width(a.p, a.s, hd);
    }
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // 128-row items (two consumers) while they fill the card; below that,
  // 64-row items, so that no consumer idles on rows past S. A row's output
  // is the same either way.
  if ((long long)((S + 127) / 128) * H * B >= sms)
    return launch_wgmma_rows<T, HDP, 2>(tq, tk, tv, q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs,
                                        os, w, scale, causal, sms, stream);
  return launch_wgmma_rows<T, HDP, 1>(tq, tk, tv, q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os,
                                      w, scale, causal, sms, stream);
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
    return launch_wgmma<T, 64>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w.opair, scale,
                               causal, s);
  if (hd <= 128)
    return launch_wgmma<T, 128>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, w.opair, scale,
                                causal, s);
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
