// Causal GQA flash attention, forward, with an online softmax:
//
//   out[b, i, h] = Σ_j softmax_j(q[b, i, h]·k[b, j, g] · hd^-½) v[b, j, g],
//   g = h / (H / KV), masked to j <= i when causal and always to j < T.
//
// Replaces the TPU kernel `_flash_kernel` (wrapper `flash_attention`) in
// src/repro/kernels/flash_attention/kernel.py, and the padding of
// `flash_attention_padded` in ops.py: this kernel takes the true S and T
// and masks the ragged tails itself.
//
// Semantics kept from the TPU kernel: scores in f32 from the inputs (bf16
// products are exact in f32), scaled after the dot; a finite mask value
// NEG = -1e30, never -inf, so exp(m_prev - m_new) is never NaN; the running
// max m, the f32 denominator l (of the unrounded p) and the f32 accumulator
// carried across k-tiles; p rounded to v's dtype before the PV product; the
// output divided by max(l, 1e-30) and cast to q's dtype once. With causal
// masking the first k-tile holds key 0 for every real query row, so no real
// row is ever fully masked. The k-tiles wholly above the diagonal would add
// exactly 0 (exp(NEG - m) underflows to 0 and alpha is 1), so they are
// skipped. No TF32 and no tensor cores: every product is an f32 FMA.
//
// Layout: q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), each
// read or written through its strides (in elements; unit stride along hd),
// so the model's (B, S, H·hd) activations need no transposed copies. GQA is
// index arithmetic: k and v are never repeated.
//
// What bounds it on an H100 SXM at the serve path's shape (B = 4,
// S = T = 1,000, H = 12, KV = 2, hd = 128, bf16): about 2·B·H·S²·hd ≈
// 12.3 GFLOP of causal work, 12.4 µs at the 989 TFLOP/s of the bf16 tensor
// cores, against 28.7 MB of inputs and outputs, 8.6 µs at 3.35 TB/s: it is
// bound by tensor-core operations. This first design does nothing about
// that yet. It runs on the CUDA cores (at most 67 TFLOP/s in f32, about
// half of that here, since each FMA pair costs one shared-memory load), so
// it sits well above its bound; `wgmma` on bf16 tiles fed by TMA is later
// work.
//
// Design: one block of 128 threads per (q-tile of BQ = 32 rows, head,
// batch), q-tiles issued from the last (the longest causal row) first. The
// block keeps its q-tile in shared memory as f32 and walks the k-tiles of
// BK = 64 keys in order, loading each k and v tile into shared memory as
// f32. Thread (rg, cg) = (tid / 16, tid % 16) owns rows rg + 8i (i < 4):
// it computes their scores against keys cg + 16j (j < 4), reduces each
// row's max and sum across the 16 threads of its half-warp by shuffles,
// writes its rounded p to shared memory, and accumulates output dims
// cg + 16j (j < 8) of its rows. Row strides are padded so that every
// shared-memory access of a warp hits distinct banks or one broadcast
// address. The k order is fixed, so the result is bit-reproducible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BK = 64;          // keys per k-tile
constexpr int THREADS = 128;
constexpr int HD_MAX = 128;
constexpr int QS = HD_MAX + 1;  // padded row stride of the q and k tiles
constexpr int VS = HD_MAX;      // row stride of the v tile
constexpr int PS = BK + 16;     // padded row stride of the p tile
constexpr int SMEM_FLOATS = BQ * QS + BK * QS + BK * VS + BQ * PS;
constexpr float NEG = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {  // in elements, for the batch, sequence and head axes
  long long b, s, h;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int S, int Tk, int H, int KV, int hd,
          Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal) {
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    sQ[r * QS + d] = (q0 + r < S) ? to_f32(qb[(long long)(q0 + r) * qs.s + d]) : 0.f;
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
      sK[r * QS + d] = in ? to_f32(kb[(long long)(k0 + r) * ks.s + d]) : 0.f;
      sV[r * VS + d] = in ? to_f32(vb[(long long)(k0 + r) * vs.s + d]) : 0.f;
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
        sP[(rg + 8 * i) * PS + cg + 16 * j] = to_f32(from_f32<T>(p));
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

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = cg + 16 * j;
      if (d < hd) ob[(long long)row * os.s + d] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk, int H,
           int KV, int hd, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);  // 92,544 B: above 48 KB, so opt in
  const cudaError_t e =
      cudaFuncSetAttribute(flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all on the
// device, of dtype 0 = f32 or 1 = bf16, with hd a multiple of 8 in
// [8, 128] and H % KV == 0 (the wrapper checks). Strides are in elements
// for the batch, sequence and head axes. Returns the cudaError_t of the
// launch (0 = success).
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
    return launch<float>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale, causal, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, hd, qs, ks, vs, os, scale,
                                 causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
