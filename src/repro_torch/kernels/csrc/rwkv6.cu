// The RWKV-6 WKV recurrence on Hopper, written by hand.
//
// Replaces _wkv_kernel in src/repro/kernels/rwkv6_kernel.py (called through
// rwkv6 there). Same function: r, k, v, w [b, s, h, n] (float32 or
// bfloat16, one type; w the decay, already exp(-exp(.)) in (0, 1)), u [h, n]
// float32, state [b, h, n, n] float32 (key x value; zeros when none is
// passed); per (batch, head) and step, in float32,
//   o_j = sum_i r_i (S_ij + u_i k_i v_j),   S_ij <- w_i S_ij + k_i v_j,
// out [b, s, h, n] in r's type and the final state [b, h, n, n] float32.
// This is the exact recurrence of the reference's oracle (ref.rwkv6_scan).
// The TPU kernel instead factors each 16-step chunk into matrix products
// over cumulative decays and clamps their exponents; at strong decays
// (w below about e^-5 every step) the clamp makes it drop pair terms that
// have not decayed. A per-step recurrence forms no such products, so it
// has no clamp and no error of that kind, and it takes any s >= 1.
//
// Design. The TPU kernel walks a (batch * head, chunk) grid with chunks
// in order and keeps the [n, n] state in VMEM scratch. Here ONE BLOCK OWNS
// ONE (batch, head) and runs the whole time loop itself, the state in
// registers from the first step to the last: 4n threads, four to a value
// column j, each holding the n/4 key rows i of S_ij it owns. A step is
//   o_j = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i),
// so the bonus is one dot product per step, not a term per state element.
// The block stages r, k, w and v of 32 steps at a time in shared memory,
// read once from device memory and converted to float32; one warp per step
// then forms the bonus dot products of the tile. Each thread reads its
// rows of r, k and w back as float4 broadcasts (a quarter's rows padded by
// 4 floats, so the four quarters of a warp fall in distinct banks), does
// 5 float32 operations per state element (an fma into the output, a
// product and an fma for the update), and the four threads of a column
// sum their parts by two warp shuffles. A decode step (s = 1) is the same
// kernel with one step. The state out is a separate buffer, so a state
// passed in is not modified, and a run split in two with the state
// carried across equals one whole run.
//
// What bounds it on the H100. At the serving path's prefill (b 4, s 2,048,
// h 64, n 64, bf16) the function does 5 n^2 float32 operations per
// (batch, head, step): 10.7 GFLOP, 0.16 ms at 67 TFLOP/s, bound by
// operations; its bytes (r, k, v, w and out in bf16, 0.34 GB, and the
// state out) take 0.10 ms at 3.35 TB/s. With 256 blocks of 256 threads
// the card holds about two blocks an SM, 16 warps; each thread's step is
// ~70 instructions (48 of them arithmetic) and one serial chain of steps,
// so issue and the chain's latency, not memory, set this first kernel's
// time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kSplit = 4;                // threads per value column
constexpr int kTile = 32;                // steps staged at a time
constexpr int kErrHeadDim = 1000;

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

template <typename T, int N>
__global__ void __launch_bounds__(kSplit * N)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ out, float* __restrict__ s_out, int s, int h) {
  constexpr int kThreads = kSplit * N;
  constexpr int kWarps = kThreads / 32;
  constexpr int kRows = N / kSplit;      // key rows a thread owns
  constexpr int kPad = kRows + 4;        // a quarter's stride in shared
  constexpr int kStride = kSplit * kPad; // one step's r, k or w in shared
  static_assert(kRows % 4 == 0 && kThreads % 32 == 0, "head dim");
  __shared__ __align__(16) float rs[kTile][kStride];
  __shared__ __align__(16) float ks[kTile][kStride];
  __shared__ __align__(16) float ws[kTile][kStride];
  __shared__ float vs[kTile][N];
  __shared__ float bonus[kTile];
  __shared__ float us[N];

  const int bh = blockIdx.x;             // batch * h + head
  const int batch = bh / h;
  const int head = bh - batch * h;
  const int tid = threadIdx.x;
  const int j = tid / kSplit;            // the value column
  const int q = tid % kSplit;            // rows q * kRows ... + kRows - 1
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < N; i += kThreads) us[i] = u[head * N + i];

  const size_t sbase = (size_t)bh * N * N;
  float S[kRows];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    S[ii] = s0 ? s0[sbase + (size_t)(q * kRows + ii) * N + j] : 0.f;

  const size_t pitch = (size_t)h * N;    // one step in [b, s, h, n]
  const size_t base = ((size_t)batch * s * h + head) * N;

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int steps = min(kTile, s - t0);
    __syncthreads();                     // the last tile's reads are done
    for (int idx = tid; idx < steps * N; idx += kThreads) {
      const int tt = idx / N, i = idx % N;
      const size_t g = base + (size_t)(t0 + tt) * pitch + i;
      const int si = (i / kRows) * kPad + i % kRows;
      rs[tt][si] = to_f32(r[g]);
      ks[tt][si] = to_f32(k[g]);
      ws[tt][si] = to_f32(w[g]);
      vs[tt][i] = to_f32(v[g]);
    }
    __syncthreads();
    // the bonus of each step, sum_i r_i u_i k_i: one warp a step
    for (int tt = warp; tt < steps; tt += kWarps) {
      float p = 0.f;
      for (int i = lane; i < N; i += 32) {
        const int si = (i / kRows) * kPad + i % kRows;
        p = fmaf(rs[tt][si] * us[i], ks[tt][si], p);
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) bonus[tt] = p;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float* rq = &rs[tt][q * kPad];
      const float* kq = &ks[tt][q * kPad];
      const float* wq = &ws[tt][q * kPad];
      const float vj = vs[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < kRows; ii += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rq + ii);
        const float4 k4 = *reinterpret_cast<const float4*>(kq + ii);
        const float4 w4 = *reinterpret_cast<const float4*>(wq + ii);
        acc[0] = fmaf(r4.x, S[ii], acc[0]);
        acc[1] = fmaf(r4.y, S[ii + 1], acc[1]);
        acc[2] = fmaf(r4.z, S[ii + 2], acc[2]);
        acc[3] = fmaf(r4.w, S[ii + 3], acc[3]);
        S[ii] = fmaf(w4.x, S[ii], k4.x * vj);
        S[ii + 1] = fmaf(w4.y, S[ii + 1], k4.y * vj);
        S[ii + 2] = fmaf(w4.z, S[ii + 2], k4.z * vj);
        S[ii + 3] = fmaf(w4.w, S[ii + 3], k4.w * vj);
      }
      float o = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      o += __shfl_xor_sync(0xffffffffu, o, 1);
      o += __shfl_xor_sync(0xffffffffu, o, 2);
      if (q == 0)
        out[base + (size_t)(t0 + tt) * pitch + j] =
            from_f32<T>(fmaf(vj, bonus[tt], o));
    }
  }
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
    s_out[sbase + (size_t)(q * kRows + ii) * N + j] = S[ii];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_out, int b,
           int s, int h, cudaStream_t stream) {
  wkv_kernel<T, N><<<b * h, kSplit * N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_out), s, h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* out, void* s_out, int b,
             int s, int h, int n, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                  stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                  stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                  stream);
    default: return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (r, k, v, w and out). s0 may be null (a
// zero state). Returns a cudaError_t, or 1000 for a head dim n other than
// 16, 32 or 64.
int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* out, void* s_out,
                 int dtype, int b, int s, int h, int n, void* stream) {
  if (n != 16 && n != 32 && n != 64) return kErrHeadDim;
  if (b <= 0 || h <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                   n, st);
  return launch_n<float>(r, k, v, w, u, s0, out, s_out, b, s, h, n, st);
}

const char* rwkv6_error_string(int code) {
  if (code == kErrHeadDim) return "head dim n other than 16, 32 or 64";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
