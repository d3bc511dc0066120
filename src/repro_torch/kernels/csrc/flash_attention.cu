// Forward attention on Hopper, written by hand: grouped-query heads,
// causal or not, with an online softmax over key/value tiles.
//
// Replaces _flash_kernel in src/repro/kernels/flash_attention.py. Same
// function: q [b, sq, h, d], k/v [b, sk, kh, d] (float32 or bfloat16),
// query head i reads kv head i / (h / kh), out [b, sq, h, d] in q's type;
// scores, running max m, denominator l and the output sum in float32;
// masked scores -1e30, causal as qpos >= kpos counted from position 0;
// the denominator floored at 1e-30 before the final division.
//
// Design. The TPU kernel walks a (head, q tile, kv tile) grid with the kv
// axis in order and keeps m/l/acc in VMEM scratch across kv steps. Here
// one thread block owns one (batch x head, 64-row q tile) and runs the kv
// loop itself, so m/l/acc never leave registers. 128 threads: thread
// (ty, tx), ty = tid / 8, tx = tid % 8, holds query rows 4 ty .. 4 ty + 3;
// of a 64-key tile it scores keys tx + 8 j (j < 8) and of the output it
// owns columns tx + 8 j (j < d / 8). A row's eight threads are eight
// neighbouring lanes of one warp, so its max and sum are three xor
// shuffles. The q tile, the k and v tiles and the probability tile are
// staged in shared memory as float32, rows padded by one word where a
// warp reads down a column, so no read has a bank conflict. Tiles wholly
// above the diagonal are never loaded (causal); rows past sq and keys
// past sk are masked, so sq and sk need not be multiples of 64. Causal
// grids start with the q tiles that have the most kv tiles to walk.
//
// What bounds it on the H100. The causal prefill of the serving path
// (b 4, sq = sk 2,048, h 64, kh 8, d 128) is 275 GFLOP: at the tensor
// cores' 989 TFLOP/s that is 0.28 ms, against 0.09 ms for its 0.30 GB of
// q, k, v and out. This first kernel multiplies on the float32 CUDA cores
// (67 TFLOP/s, fused multiply-adds from shared memory), so it is bound by
// operations and cannot come near that bound; wgmma on bfloat16 tiles
// fed by TMA is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kRows = kBlockQ / 16;      // query rows per thread
constexpr int kCols = kBlockK / 8;       // keys per thread per tile
constexpr float kNegInf = -1e30f;
constexpr int kErrHeadDim = 1000;
static_assert(kBlockQ == kBlockK, "load_tile stages 64-row tiles of both");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockK * D + kBlockQ * (kBlockK + 1));
}

// Copy rows [row0, row0 + 64) of one head of a [b, s, heads, D] tensor
// into a float tile of row stride `ld`, zeros past `s`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, int ld,
                                          const T* __restrict__ src,
                                          int batch, int s, int heads,
                                          int head, int row0) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int pos = row0 + r;
    float v = 0.f;
    if (pos < s) {
      v = to_f32(src[(((size_t)batch * s + pos) * heads + head) * D + c]);
    }
    tile[r * ld + c] = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int h, int kh, float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                              // [64][D + 1]
  float* ks = qs + kBlockQ * (D + 1);            // [64][D + 1]
  float* vs = ks + kBlockK * (D + 1);            // [64][D]
  float* ps = vs + kBlockK * D;                  // [64][65]

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int n_qtiles = gridDim.y;
  const int qtile = causal ? n_qtiles - 1 - (int)blockIdx.y : blockIdx.y;
  const int q0 = qtile * kBlockQ;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  // kv tiles to walk: all, or (causal) those with a key <= the tile's
  // last query row
  int n_kv = (sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int last = min(min(q0 + kBlockQ, sq), sk) - 1;
    n_kv = min(n_kv, last / kBlockK + 1);
  }

  load_tile<T, D>(qs, D + 1, q, batch, sq, h, head, q0);

  float m[kRows], l[kRows], acc[kRows][D / 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[i][j] = 0.f;
  }

  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * kBlockK;
    __syncthreads();                    // the last tile's reads are done
    load_tile<T, D>(ks, D + 1, k, batch, sk, kh, kv_head, k0);
    load_tile<T, D>(vs, D, v, batch, sk, kh, kv_head, k0);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qr[kRows], kr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = qs[(ty * kRows + i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kr[j] = ks[(tx + 8 * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (causal && kpos > qpos) x = kNegInf;
        if (kpos >= sk) x = -CUDART_INF_F;   // past the keys: weight 0
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
      const float m_new = fmaxf(m[i], tile_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * kRows + i) * (kBlockK + 1) + tx + 8 * j] = p;
        row_sum += p;
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 4);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                    // the probability tile is whole

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = ps[(ty * kRows + i) * (kBlockK + 1) + kk];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float vv = vs[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty * kRows + i;
    if (qpos >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* dst = o + (((size_t)batch * sq + qpos) * h + head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dst[tx + 8 * j] = from_f32<T>(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kh, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * h, (sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kh, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int h, int kh, int d, float scale, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, sk, h, kh, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, sk, h, kh, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, sk, h, kh, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, sk, h, kh, scale, causal, stream);
    default: return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. Returns a cudaError_t, or 1000 for a
// head dim the kernel is not built for (32, 64 and 128 are).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int b, int sq, int sk, int h,
                           int kh, int d, float scale, int causal,
                           void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh, d, scale,
                                   causal, st);
  return launch_d<float>(q, k, v, o, b, sq, sk, h, kh, d, scale, causal, st);
}

const char* flash_attention_error_string(int code) {
  if (code == kErrHeadDim) return "head dim not built (16, 32, 64, 128)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
