// flash_wide_kernel in its first form, kept beside the port as the
// baseline that the redesigned wide kernels of
// src/repro_torch/kernels/csrc/flash_attention.cu are timed against, and
// as the copy that tools/flash_f32_probe.py builds with a part left out.
//
// The first form (head dims past 256, bf16 or float32, mma.sync): q and K
// streamed through a two-stage cp.async ring in 64-column chunks, v split
// across blocks in slices of 64, 128 or 256 columns, each slice's block
// recomputing S; four warps over 64 query rows, 32-key tiles.
//
// Exports flash_attention_launch and flash_attention_error_string with
// the signatures of the port's library, so its wrapper
// (repro_torch.kernels.flash_attention) launches through this one; head
// dims up to 256 return 1000 (refused). Defines that leave a part out,
// for timing only (the results are wrong):
//   WIDE_ONE_SLICE    only the first v slice runs (no recomputed S)
//   WIDE_NO_PV        no P V products (the softmax stays)
//   WIDE_V32          V's bf16 B fragments read as two 32-bit words
//   WIDE_NO_BARRIERS  no block barriers between the q/K chunks
//
// Build: nvcc with the flags of repro_torch.kernels.build.FLAGS
// ["flash_attention"] and -I src/repro_torch/kernels/csrc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_opt_in.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kErrHeadDim = 1000;
constexpr int kErrAlign = 1003;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x in one special-function instruction (flushes results below 2^-126
// to zero: such probabilities are nothing beside the row's largest, 1)
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global to shared memory, asynchronously; bytes 0 writes
// 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr int kWideWarps = 4;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideRows = 16 * kWideWarps;    // q tile: 16 rows a warp
constexpr int kWideKeys = 32;                 // keys a K/V tile holds
constexpr int kWideChunk = 64;                // q/k columns a chunk holds
constexpr int kWideLd = kWideChunk + 8;       // q/k chunk row stride
// V slice row stride: float32 DVS + 4 (rows 2q and 2q + 1 at column g on
// 32 distinct banks), bf16 DVS + 8 (a row 4 words mod 32)
template <typename T>
__host__ __device__ constexpr int wide_ldv(int dvs) {
  return dvs + (sizeof(T) == 4 ? 4 : 8);
}
template <typename T>
constexpr size_t wide_smem_bytes(int dvs) {
  return sizeof(T) * ((size_t)2 * (kWideRows + kWideKeys) * kWideLd +
                      (size_t)kWideKeys * wide_ldv<T>(dvs));
}
// the v slice a head dim dv runs at: 64, 128 or 256 columns
__host__ __device__ constexpr int wide_slice(int dv) {
  return dv <= 64 ? 64 : dv <= 128 ? 128 : 256;
}

// rows [0, rows) x columns [0, cols) of a row-major source (row stride
// `stride` elements) into shared memory (row stride ld), in 16-byte
// pieces shared by the block's threads; pieces of rows from `valid_rows`
// on, or of columns from `valid_cols` on, are zero-filled and read
// nothing (cols and valid_cols whole pieces)
template <typename T>
__device__ __forceinline__ void wide_copy(T* dst, int ld, const T* src,
                                          size_t stride, int rows, int cols,
                                          int valid_rows, int valid_cols) {
  constexpr int kPiece = 16 / sizeof(T);
  const int per_row = cols / kPiece;
  for (int i = threadIdx.x; i < rows * per_row; i += kWideThreads) {
    const int r = i / per_row, c = (i % per_row) * kPiece;
    const bool in = r < valid_rows && c < valid_cols;
    cp_async16(dst + r * ld + c, src + (in ? r * stride + c : 0),
               in ? 16 : 0);
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  __nv_bfloat162 v(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s[x] (keys 8 x .. 8 x + 7 of the tile) += the warp's 16 q rows times
// those keys over the `cols` columns of one chunk; bf16: m16n8k16
template <int NK>
__device__ __forceinline__ void wide_qk(float (&s)[NK][4], float (&)[NK][4],
                                        const __nv_bfloat16* qs,
                                        const __nv_bfloat16* ks, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  for (int kk = 0; kk < cols; kk += 16) {
    const __nv_bfloat16* qa = qs + g * kWideLd + kk + 2 * qd;
    const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * kWideLd),
                           ld_u32(qa + 8), ld_u32(qa + 8 * kWideLd + 8)};
#pragma unroll
    for (int x = 0; x < NK; ++x) {
      const __nv_bfloat16* kb = ks + (8 * x + g) * kWideLd + kk + 2 * qd;
      const uint32_t b[2] = {ld_u32(kb), ld_u32(kb + 8)};
      mma_bf16(s[x], a, b);
    }
  }
}
// float32: 3xTF32 m16n8k8, hi hi into s, the cross terms into cr, in the
// permuted order of flash_f32_kernel (A's column q is element 2q of a
// group of 8, its column q + 4 element 2q + 1; K's likewise)
template <int NK>
__device__ __forceinline__ void wide_qk(float (&s)[NK][4], float (&cr)[NK][4],
                                        const float* qs, const float* ks,
                                        int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
  for (int kk = 0; kk < cols; kk += 8) {
    const float2 r0 =
        *reinterpret_cast<const float2*>(qs + g * kWideLd + kk + 2 * qd);
    const float2 r1 = *reinterpret_cast<const float2*>(
        qs + (g + 8) * kWideLd + kk + 2 * qd);
    uint32_t ah[4], al[4];
    split_tf32(r0.x, ah[0], al[0]);
    split_tf32(r1.x, ah[1], al[1]);
    split_tf32(r0.y, ah[2], al[2]);
    split_tf32(r1.y, ah[3], al[3]);
#pragma unroll
    for (int x = 0; x < NK; ++x) {
      const float2 f = *reinterpret_cast<const float2*>(
          ks + (8 * x + g) * kWideLd + kk + 2 * qd);
      uint32_t bh[2], bl[2];
      split_tf32(f.x, bh[0], bl[0]);
      split_tf32(f.y, bh[1], bl[1]);
      mma_tf32(cr[x], al, bh);
      mma_tf32(cr[x], ah, bl);
      mma_tf32(s[x], ah, bh);
    }
  }
}

// acc += P V over the tile's 32 keys for the slice's `cols` columns;
// P (the exponentiated scores, float32, in S's accumulator layout).
// bf16: P rounded to bf16, S tiles 2t and 2t + 1 are the A operand of
// keys 16 t .. 16 t + 15; V's B fragment (keys 16 t + 2q, + 1, + 8, + 9
// at column 8 y + g) by 16-bit reads
template <int NV>
__device__ __forceinline__ void wide_pv(float (&acc)[NV][4],
                                        const float (&p)[kWideKeys / 8][4],
                                        const float (&corr)[2],
                                        const __nv_bfloat16* vs, int ldv,
                                        int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int y = 0; y < NV; ++y)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[y][e] *= corr[e >> 1];
#pragma unroll
  for (int t = 0; t < kWideKeys / 16; ++t) {
    const uint32_t a[4] = {pack_bf16(p[2 * t][0], p[2 * t][1]),
                           pack_bf16(p[2 * t][2], p[2 * t][3]),
                           pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]),
                           pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3])};
    const __nv_bfloat16* vt = vs + (16 * t + 2 * qd) * ldv + g;
#pragma unroll
    for (int y = 0; y < NV; ++y) {
      if (8 * y >= cols) break;
      const __nv_bfloat16* vb = vt + 8 * y;
#ifdef WIDE_V32
      // two aligned 32-bit words near the fragment's (wrong values)
      const uint32_t b[2] = {ld_u32(vb - (g & 1)),
                             ld_u32(vb - (g & 1) + 8 * ldv)};
#else
      const uint32_t b[2] = {pack2(vb[0], vb[ldv]),
                             pack2(vb[8 * ldv], vb[9 * ldv])};
#endif
      mma_bf16(acc[y], a, b);
    }
  }
}
// float32: the tile's P V in 3xTF32 (cross terms first) into a sum of its
// own, 8 output groups a pass, then one rounded multiply-add with the
// rescale into the running sum, as flash_f32_kernel does; P's A fragment
// is the S accumulator's (c0, c2, c1, c3)
template <int NV>
__device__ __forceinline__ void wide_pv(float (&acc)[NV][4],
                                        const float (&p)[kWideKeys / 8][4],
                                        const float (&corr)[2],
                                        const float* vs, int ldv, int cols) {
  constexpr int YC = NV < 8 ? NV : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int y0 = 0; y0 < NV; y0 += YC) {
    if (8 * y0 >= cols) break;
    float t[YC][4];
#pragma unroll
    for (int yy = 0; yy < YC; ++yy)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[yy][e] = 0.f;
#pragma unroll
    for (int x = 0; x < kWideKeys / 8; ++x) {
      uint32_t ah[4], al[4];
      split_tf32(p[x][0], ah[0], al[0]);
      split_tf32(p[x][2], ah[1], al[1]);
      split_tf32(p[x][1], ah[2], al[2]);
      split_tf32(p[x][3], ah[3], al[3]);
#pragma unroll
      for (int yy = 0; yy < YC; ++yy) {
        if (8 * (y0 + yy) >= cols) break;
        const float* vb = vs + (8 * x + 2 * qd) * ldv + 8 * (y0 + yy) + g;
        uint32_t bh[2], bl[2];
        split_tf32(vb[0], bh[0], bl[0]);
        split_tf32(vb[ldv], bh[1], bl[1]);
        mma_tf32(t[yy], al, bh);
        mma_tf32(t[yy], ah, bl);
        mma_tf32(t[yy], ah, bh);
      }
    }
#pragma unroll
    for (int yy = 0; yy < YC; ++yy)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[y0 + yy][e] = fmaf(acc[y0 + yy][e], corr[e >> 1], t[yy][e]);
  }
}

__device__ __forceinline__ void wide_store(__nv_bfloat16* dst, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void wide_store(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// T: __nv_bfloat16 or float; DVS: the v slice's columns (64, 128, 256).
// dq and dv are the real dims, multiples of 8; blockIdx.z is the slice.
template <typename T, int DVS>
__global__ void __launch_bounds__(kWideThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int sq,
                  int sk, int h, int kh, int dq, int dv, float scale_log2,
                  int causal) {
  constexpr int NK = kWideKeys / 8;          // 8-key groups of a tile
  constexpr int NV = DVS / 8;                // 8-column groups of a slice
  // bf16 takes k16 steps: a chunk's columns are copied to a multiple of
  // 16, the ones past dq as zeros
  constexpr int kStep = sizeof(T) == 4 ? 8 : 16;
  constexpr int LDV = wide_ldv<T>(DVS);
  extern __shared__ __align__(16) unsigned char smem_wide[];
  T* qs = reinterpret_cast<T*>(smem_wide);           // [2][64][kWideLd]
  T* ks = qs + 2 * kWideRows * kWideLd;              // [2][32][kWideLd]
  T* vs = ks + 2 * kWideKeys * kWideLd;              // [32][LDV]

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int qtile = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                           : (int)blockIdx.y;
  const int q0 = qtile * kWideRows;
  const int v0 = blockIdx.z * DVS;
  const int vcols = min(DVS, dv - v0);       // the slice's real columns
  int n_kv = (sk + kWideKeys - 1) / kWideKeys;
  if (causal) {
    const int last = min(min(q0 + kWideRows, sq), sk) - 1;
    n_kv = min(n_kv, last / kWideKeys + 1);
  }
  const int n_chunks = (dq + kWideChunk - 1) / kWideChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int qw = q0 + 16 * warp;             // the warp's first row

  const size_t q_stride = (size_t)h * dq, k_stride = (size_t)kh * dq;
  const size_t v_stride = (size_t)kh * dv;
  const T* q_tile = q + (((size_t)batch * sq + q0) * h + head) * dq;
  const T* k_head = k + ((size_t)batch * sk * kh + kv_head) * dq;
  const T* v_head = v + ((size_t)batch * sk * kh + kv_head) * dv + v0;
  // the q and K columns of chunk c into stage c % 2
  auto load_chunk = [&](int c, int k0) {
    const int c0 = c * kWideChunk, st = c % 2;
    const int cols = min(kWideChunk, (dq - c0 + kStep - 1) / kStep * kStep);
    wide_copy(qs + st * kWideRows * kWideLd, kWideLd, q_tile + c0, q_stride,
              kWideRows, cols, sq - q0, dq - c0);
    wide_copy(ks + st * kWideKeys * kWideLd, kWideLd,
              k_head + k0 * k_stride + c0, k_stride, kWideKeys, cols,
              sk - k0, dq - c0);
    cp_async_commit();
  };

  float acc[NV][4];
#pragma unroll
  for (int y = 0; y < NV; ++y)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[y][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kWideKeys;
    wide_copy(vs, LDV, v_head + k0 * v_stride, v_stride, kWideKeys,
              (vcols + 7) / 8 * 8, sk - k0, vcols);
    cp_async_commit();
    load_chunk(0, k0);
    // a warp whose rows all lie past sq, or above the diagonal for every
    // key of the tile, adds nothing (p = 0, the running max unchanged)
    const bool active = qw < sq && !(causal && k0 > qw + 15);
    float s[NK][4], cr[NK][4];
#pragma unroll
    for (int x = 0; x < NK; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[x][e] = cr[x][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(c + 1, k0);
        cp_async_wait<1>();                  // V and chunk c have arrived
      } else {
        cp_async_wait<0>();
      }
#ifndef WIDE_NO_BARRIERS
      __syncthreads();
#endif
      const int st = c % 2, c0 = c * kWideChunk;
      if (active)
        wide_qk(s, cr, qs + st * kWideRows * kWideLd + 16 * warp * kWideLd,
                ks + st * kWideKeys * kWideLd,
                min(kWideChunk, (dq - c0 + kStep - 1) / kStep * kStep));
#ifndef WIDE_NO_BARRIERS
      __syncthreads();                       // before stage st refills
#endif
    }
    if (active) {
      // masked scores -1e30, keys past sk -inf, before the scaling; lane
      // (g, q) holds rows g and g + 8, keys 8 x + 2q and 8 x + 2q + 1
      const bool edge =
          (causal && k0 + kWideKeys - 1 > qw) || k0 + kWideKeys > sk;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int x = 0; x < NK; ++x) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sc = s[x][e] + cr[x][e];
          if (edge) {
            const int kpos = k0 + 8 * x + 2 * qd + (e & 1);
            if (causal && kpos > qw + g + 8 * (e >> 1)) sc = kNegInf;
            if (kpos >= sk) sc = -CUDART_INF_F;
          }
          s[x][e] = sc;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc);
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = fexp2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int x = 0; x < NK; ++x) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[x][e] = fexp2(fmaf(s[x][e], scale_log2, -m[e >> 1]));
          sum[e >> 1] += s[x][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#ifndef WIDE_NO_PV
      wide_pv(acc, s, corr, vs, LDV, vcols);
#endif
    }
    __syncthreads();                         // before V and stage 0 refill
  }

  // the slice's real columns only (whole 8-column groups)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    if (qpos >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = o + (((size_t)batch * sq + qpos) * h + head) * dv + v0 + 2 * qd;
#pragma unroll
    for (int y = 0; y < NV; ++y)
      if (8 * y < vcols)
        wide_store(dst + 8 * y, acc[y][2 * r] * inv_l,
                   acc[y][2 * r + 1] * inv_l);
  }
}

// flash_wide_kernel at dv's slice DVS
template <typename T, int DVS>
int launch_wide(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int h, int kh, int dq, int dv, float scale,
                int causal, cudaStream_t stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kErrAlign;
  constexpr size_t bytes = wide_smem_bytes<T>(DVS);
  const cudaError_t attr =
      smem_opt_in(flash_wide_kernel<T, DVS>, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
#ifdef WIDE_ONE_SLICE
  const dim3 grid(b * h, (sq + kWideRows - 1) / kWideRows, 1);
#else
  const dim3 grid(b * h, (sq + kWideRows - 1) / kWideRows,
                  (dv + DVS - 1) / DVS);
#endif
  flash_wide_kernel<T, DVS><<<grid, kWideThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kh, dq, dv,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide_type(const void* q, const void* k, const void* v, void* o,
                     int b, int sq, int sk, int h, int kh, int dq, int dv,
                     float scale, int causal, cudaStream_t stream) {
  switch (wide_slice(dv)) {
    case 64:
      return launch_wide<T, 64>(q, k, v, o, b, sq, sk, h, kh, dq, dv, scale,
                                causal, stream);
    case 128:
      return launch_wide<T, 128>(q, k, v, o, b, sq, sk, h, kh, dq, dv,
                                 scale, causal, stream);
    default:
      return launch_wide<T, 256>(q, k, v, o, b, sq, sk, h, kh, dq, dv,
                                 scale, causal, stream);
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16; only head dims past 256 (either), as the
// port's flash_attention_launch takes them; others return 1000
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int b, int sq, int sk, int h,
                           int kh, int dq, int dv, float scale, int causal,
                           void* stream) {
  if (dq % 8 || dv % 8 || (dq <= kMaxHeadDim && dv <= kMaxHeadDim))
    return kErrHeadDim;
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == 1
             ? launch_wide_type<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, kh,
                                               dq, dv, scale, causal, st)
             : launch_wide_type<float>(q, k, v, o, b, sq, sk, h, kh, dq, dv,
                                       scale, causal, st);
}
const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim:
      return "this build takes only head dims past 256, multiples of 8";
    case kErrAlign: return "operands must be 16-byte aligned";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
