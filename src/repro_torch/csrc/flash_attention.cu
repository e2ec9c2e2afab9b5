// Causal GQA flash attention, forward, with an online softmax:
//
//   out[b, i, h] = Σ_j softmax_j(q[b, i, h]·k[b, j, g] · hd^-½) v[b, j, g],
//   g = h / (H / KV), masked to j <= i when causal and always to j < T.
//
// Replaces the TPU kernel `_flash_kernel` (wrapper `flash_attention`) in
// src/repro/kernels/flash_attention/kernel.py:29/:70, and the padding of
// `flash_attention_padded` in ops.py: both kernels here take the true S and
// T and mask the ragged tails themselves.
//
// Two routes, chosen by dtype in the entry point at the end:
//   - bf16: `flash_fwd_mma`, on the tensor cores (mma.sync m16n8k16);
//   - f32:  `flash_fwd_f32`, on the CUDA cores, every product an f32 FMA.
//     It is the f32 route because TF32 is not allowed where the port is
//     held to the reference at atol 2e-5.
//
// Semantics shared by both, which the plain version `flash_attention_plain`
// computes: scores in f32 from the inputs (bf16 products are exact in f32),
// scaled after the dot; a finite mask value NEG = -1e30, never -inf, so
// exp(m_prev - m_new) is never NaN; the running max m, the f32 denominator
// l (of the unrounded p) and the f32 accumulator carried across k-tiles in
// a fixed order (no split over keys, no atomics: bit-reproducible); p
// rounded to v's dtype before the PV product; the output divided by
// max(l, 1e-30) and cast to q's dtype once. With causal masking the first
// k-tile holds key 0 for every real query row, so no real row is ever
// fully masked. The k-tiles wholly above the diagonal would add exactly 0
// (exp(NEG - m) underflows to 0 and alpha is 1), so they are skipped.
//
// Layout: q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), each
// read or written through its strides (in elements; unit stride along hd),
// so the model's (B, S, H·hd) activations need no transposed copies. GQA is
// index arithmetic: k and v are never repeated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;

struct Strides {  // in elements, for the batch, sequence and head axes
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// bf16 route: flash_fwd_mma
//
// What bounds it on an H100 SXM at the serve path's shape (B = 4,
// S = T = 1,000, H = 12, KV = 2, hd = 128): 2·B·H·S²·hd = 12.29 GFLOP of
// causal work, 0.0124 ms at the 989 TFLOP/s of the bf16 tensor cores,
// against 28.7 MB of inputs and outputs, 0.0086 ms at 3.35 TB/s: it is
// bound by tensor-core operations. The design, FlashAttention-2's shape:
//
// - One block of 4 warps per (64-row q-tile, head, batch); each warp owns
//   16 query rows. q-tiles are issued from the last (the longest causal
//   row) first.
// - Q, K and V tiles are copied from device memory with cp.async, 16 bytes
//   a thread, rows past S or T and the head-dim pad zero-filled. K and V
//   tiles of 64 keys are double-buffered: tile j + 1 is in flight while
//   tile j's products run. One barrier per k-tile.
// - Tiles stay bf16 in shared memory, rows padded by 8 elements (16 B), so
//   the 8 row addresses of each ldmatrix fall in 8 distinct 16-byte bank
//   groups: no bank conflicts. At hd 128 that is 17,408 B of Q and 69,632 B
//   for two stages of K and V, 87,040 B: two blocks fit on an SM.
// - S = QKᵀ on mma.sync.m16n8k16 (bf16 in, f32 accumulate): Q's A fragments
//   are loaded once by ldmatrix and kept in registers; K's B fragments come
//   by ldmatrix from the row-major (key, dim) tile.
// - The online softmax runs on the accumulator fragments: a row lives in a
//   quad of 4 lanes, reduced by two xor shuffles. exp2 with log₂e folded
//   into the scale.
// - O += PV: two adjacent m16n8 accumulators of S are exactly one m16n8k16
//   A fragment, so P goes from registers to the next product without
//   shared memory. V's B fragments come by ldmatrix.trans. O stays in
//   registers, 16 × HDP f32 a warp.
// - Only the k-tiles that cross the diagonal or hold the ragged T tail are
//   masked element by element.
// - Template on the padded head dim HDP (32, 64, 128): hd is rounded up to
//   the next HDP, the pad columns of Q and K are zero in shared memory (so
//   they add 0 to every dot), and output columns >= hd are never written.
// mma.sync rather than wgmma + TMA: P is the next product's register
// operand with no change of layout, and nothing depends on a shared-memory
// descriptor or a driver-built tensor map.
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;  // query rows per block, 16 per warp
constexpr int MMA_BK = 64;  // keys per k-tile
constexpr int MMA_THREADS = 128;

template <int HDP>
struct MmaTile {
  static constexpr int LD = HDP + 8;       // row stride in elements
  static constexpr int ELEMS = 64 * LD;    // one 64-row tile
  static constexpr size_t SMEM = 5 * ELEMS * sizeof(__nv_bfloat16);  // Q + 2 × (K, V)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with `in` false the 16 bytes are zeroed
// and `src` is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
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

// d += a·b for one m16n8k16 tile: a the 16×16 A fragment, (b0, b1) the
// 16×8 B fragment, d the 16×8 f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows row0 .. row0 + 63 of a (rows, hd) operand into a (64, LD) tile:
// rows >= nrows and 16-byte chunks at or past hd are zero-filled.
template <int HDP>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int nrows, int hd,
                                          int tid) {
  constexpr int CPR = HDP / 8;  // 16-byte chunks per row
  constexpr int LD = MmaTile<HDP>::LD;
#pragma unroll
  for (int i = 0; i < 64 * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx / CPR, c = idx % CPR;
    const bool in = row0 + r < nrows && c * 8 < hd;
    const __nv_bfloat16* g = in ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * LD + c * 8, g, in);
  }
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int Tk,
              int H, int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os,
              float scale_log2, int causal) {
  constexpr int LD = MmaTile<HDP>::LD;
  constexpr int ELEMS = MmaTile<HDP>::ELEMS;
  constexpr int KSTEPS = HDP / 16;   // k-steps of QKᵀ over the head dim
  constexpr int NB_S = MMA_BK / 8;   // n-blocks of S over the keys
  constexpr int PSTEPS = MMA_BK / 16;  // k-steps of PV over the keys
  constexpr int NB_O = HDP / 8;      // n-blocks of O over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + ELEMS;      // two stages
  __nv_bfloat16* sV = sK + 2 * ELEMS;  // two stages

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the fragment's row group and column pair
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix: which 8×8 matrix, which row of it
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + g * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + g * vs.h;

  copy_tile<HDP>(sQ, qb, qs.s, q0, S, hd, tid);
  copy_tile<HDP>(sK, kb, ks.s, 0, Tk, hd, tid);
  copy_tile<HDP>(sV, vb, vs.s, 0, Tk, hd, tid);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float o[NB_O][4];
#pragma unroll
  for (int n = 0; n < NB_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG};  // running max (log2 domain) of rows grp and grp + 8
  float l[2] = {0.f, 0.f};  // this lane's part of their denominators
  const int row0 = q0 + warp * 16 + grp;  // and row0 + 8

  const int kend = causal ? min(Tk, q0 + MMA_BQ) : Tk;
  const int ntiles = (kend + MMA_BK - 1) / MMA_BK;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * MMA_BK;
    // tile j has landed for every thread, and every warp is done with
    // tile j - 1, whose stage the next copy overwrites
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles) {
      const int st = (j + 1) & 1;
      copy_tile<HDP>(sK + st * ELEMS, kb, ks.s, k0 + MMA_BK, Tk, hd, tid);
      copy_tile<HDP>(sV + st * ELEMS, vb, vs.s, k0 + MMA_BK, Tk, hd, tid);
    }
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* cK = sK + (j & 1) * ELEMS;
    const __nv_bfloat16* cV = sV + (j & 1) * ELEMS;

    // S = Q Kᵀ: 16 rows × 64 keys a warp
    float s[NB_S][4];
#pragma unroll
    for (int n = 0; n < NB_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NB_S / 2; ++n2) {
        // matrices: keys 16·n2 + {0, 8} × dims 16·kk + {0, 8}
        uint32_t kf[4];
        ldmatrix_x4(kf, cK + (n2 * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, mask, and the online softmax on the fragments
    const bool masked = k0 + MMA_BK > Tk || (causal && k0 + MMA_BK - 1 > q0);
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
    uint32_t pf[PSTEPS][4];  // P as the A fragments of PV, rounded to bf16
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NB_S; ++n) {
      const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
      const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pf[n >> 1][2 * (n & 1)] = pack_bf16(p0, p1);      // row grp
      pf[n >> 1][2 * (n & 1) + 1] = pack_bf16(p2, p3);  // row grp + 8
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

    // O += P V
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NB_O / 2; ++n2) {
        // matrices: keys 16·kk + {0, 8} × dims 16·n2 + {0, 8}, transposed
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, cV + (kk * 16 + (mi & 1) * 8 + mr) * LD + n2 * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * n2], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  // a row's denominator is the sum over its quad, in one fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < NB_O; ++n) {
    if (n * 8 >= hd) continue;
    const int col = n * 8 + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row < S)
        *reinterpret_cast<uint32_t*>(ob + (long long)row * os.s + col) =
            pack_bf16(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    }
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
               int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = MmaTile<HDP>::SMEM;  // 87,040 B at HDP 128: above 48 KB, so opt in
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma<HDP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + MMA_BQ - 1) / MMA_BQ, H, B);
  const float log2e = 1.4426950408889634f;
  flash_fwd_mma<HDP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, Tk, H, KV, hd,
      qs, ks, vs, os, scale * log2e, causal);
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
// Design: one block of 128 threads per (q-tile of BQ = 32 rows, head,
// batch), q-tiles issued from the last (the longest causal row) first. The
// block keeps its q-tile in shared memory and walks the k-tiles of BK = 64
// keys in order, loading each k and v tile into shared memory. Thread
// (rg, cg) = (tid / 16, tid % 16) owns rows rg + 8i (i < 4): it computes
// their scores against keys cg + 16j (j < 4), reduces each row's max and
// sum across the 16 threads of its half-warp by shuffles, writes its p to
// shared memory, and accumulates output dims cg + 16j (j < 8) of its rows.
// Row strides are padded so that every shared-memory access of a warp hits
// distinct banks or one broadcast address.
// ---------------------------------------------------------------------------

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 64;          // keys per k-tile
constexpr int THREADS = 128;
constexpr int HD_MAX = 128;
constexpr int QS = HD_MAX + 1;  // padded row stride of the q and k tiles
constexpr int VS = HD_MAX;      // row stride of the v tile
constexpr int PS = BK + 16;     // padded row stride of the p tile
constexpr int SMEM_FLOATS = BQ * QS + BK * QS + BK * VS + BQ * PS;

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S, int Tk, int H, int KV,
              int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * VS;

  const int tid = threadIdx.x;
  const int cg = tid & 15;
  const int rg = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    sQ[r * QS + d] = (q0 + r < S) ? qb[(long long)(q0 + r) * qs.s + d] : 0.f;
  }

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
    __syncthreads();  // the previous tile's reads of sK, sV and sP are done
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, d = i - r * hd;
      const bool in = r < kn;
      sK[r * QS + d] = in ? kb[(long long)(k0 + r) * ks.s + d] : 0.f;
      sV[r * VS + d] = in ? vb[(long long)(k0 + r) * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
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
        psum += p;
        sP[(rg + 8 * i) * PS + cg + 16 * j] = p;
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
        if (d < hd) {
          const float vv = sV[c * VS + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
        }
      }
    }
  }

  float* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = cg + 16 * j;
      if (d < hd) ob[(long long)row * os.s + d] = acc[i][j] / denom;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
               int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);  // 92,544 B: above 48 KB, so opt in
  const cudaError_t e =
      cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_f32<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

// 16-byte copies need 16-byte aligned rows: the base and every stride
bool aligned16(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.s % 8 == 0 && s.h % 8 == 0;
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all on the
// device, of dtype 0 = f32 or 1 = bf16, with hd a multiple of 8 in
// [8, 128] and H % KV == 0 (the wrapper checks); in bf16 every base
// pointer is 16-byte aligned and every stride a multiple of 8 elements.
// Strides are in elements for the batch, sequence and head axes. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int B, int S, int Tk, int H, int KV, int hd,
                                   long long qsb, long long qss, long long qsh,
                                   long long ksb, long long kss, long long ksh,
                                   long long vsb, long long vss, long long vsh,
                                   long long osb, long long oss, long long osh,
                                   float scale, int causal, void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > HD_MAX || KV < 1 || H % KV != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  if (dtype != 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) || !aligned16(out, os))
    return (int)cudaErrorMisalignedAddress;
  if (hd <= 32)
    return launch_mma<32>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  if (hd <= 64)
    return launch_mma<64>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  return launch_mma<128>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
