// The Mamba-1 selective scan on Hopper, written by hand.
//
// Replaces _ssm_kernel in src/repro/kernels/ssm_scan.py. Same function:
// x, dt [b, s, di] and B, C [b, s, n] (float32 or bfloat16), A [di, n] and
// D [di] float32, state [b, di, n] float32 (zeros when none is passed);
// per channel and step, in float32,
//   h = exp(dt * A) * h + (dt * x) * B,   y = sum_n h * C + D * x,
// y [b, s, di] in x's type and the final state [b, di, n] float32.
//
// Design. The TPU kernel walks a (batch, channel block, time chunk) grid
// with time in order and keeps the [d_blk, n] state in VMEM scratch across
// chunks. Here ONE THREAD OWNS ONE (batch, channel) and runs the whole
// time loop itself, its n <= 16 state values in registers from the first
// step to the last; a block is 128 neighbouring channels of one batch row,
// so each step's x, dt and y are one coalesced access per warp. B_t and
// C_t are the same for every channel of a batch row: the block stages 64
// steps of them at a time in shared memory, read once from device memory,
// and every thread reads them back as broadcasts. A decode step (s = 1)
// is the same kernel with one step: read the state, update, write it.
// The state out is a separate buffer, so a state passed in is not
// modified, and a run split in two with the state carried across equals
// one whole run.
//
// What bounds it on the H100. At the serving path's prefill (b 4, s 2,048,
// di 16,384, n 16, bf16) the kernel must move 0.81 GB (x, dt and y,
// 0.27 GB each): 0.24 ms at 3.35 TB/s, bound by bytes. Its float32 work
// is 7 operations per state element (dt * A, exp, the product and fma of
// the update, the fma into y; exp counted as one) plus 3 per channel-step,
// ~15.5 GFLOP, 0.23 ms at 67 TFLOP/s. Each thread's steps form one serial
// chain, so with 512 blocks (~16 warps an SM) the chain's latency, not the
// memory, is what this first kernel will show.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;               // steps of B, C staged at a time
constexpr int kMaxState = 16;
constexpr int kErrStateDim = 1000;

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
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ D,
                const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ s_out, int s, int di) {
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];
  const int batch = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < di;

  float a[N], h[N];
  float d_skip = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)ch * N + n] : 0.f;
    h[n] = (live && s0) ? s0[((size_t)batch * di + ch) * N + n] : 0.f;
  }
  if (live) d_skip = D[ch];

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int steps = min(kChunk, s - t0);
    __syncthreads();                    // the last chunk's reads are done
    for (int idx = threadIdx.x; idx < steps * N; idx += kThreads) {
      const size_t g = ((size_t)batch * s + t0) * N + idx;
      bs[idx / N][idx % N] = to_f32(B[g]);
      cs[idx / N][idx % N] = to_f32(C[g]);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const size_t at = ((size_t)batch * s + t0 + tt) * di + ch;
      const float xv = to_f32(x[at]);
      const float dv = to_f32(dt[at]);
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dv * a[n]) * h[n] + dx * bs[tt][n];
        acc = fmaf(h[n], cs[tt][n], acc);
      }
      y[at] = from_f32<T>(acc + d_skip * xv);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n)
      s_out[((size_t)batch * di + ch) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* s0, void* y,
           void* s_out, int b, int s, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, b);
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), s, di);
  return (int)cudaGetLastError();
}

#define SSM_CASE(NN)                                                       \
  case NN:                                                                 \
    return launch<T, NN>(x, dt, A, B, C, D, s0, y, s_out, b, s, di, stream);

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* B,
             const void* C, const void* D, const void* s0, void* y,
             void* s_out, int b, int s, int di, int n, cudaStream_t stream) {
  switch (n) {
    SSM_CASE(1) SSM_CASE(2) SSM_CASE(3) SSM_CASE(4) SSM_CASE(5) SSM_CASE(6)
    SSM_CASE(7) SSM_CASE(8) SSM_CASE(9) SSM_CASE(10) SSM_CASE(11)
    SSM_CASE(12) SSM_CASE(13) SSM_CASE(14) SSM_CASE(15) SSM_CASE(16)
    default: return kErrStateDim;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (x, dt, B, C and y). s0 may be null
// (a zero state). Returns a cudaError_t, or 1000 for a state dim n
// outside 1..16.
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, const void* D,
                    const void* s0, void* y, void* s_out, int dtype, int b,
                    int s, int di, int n, void* stream) {
  if (b <= 0 || di <= 0) return 0;
  if (n < 1 || n > kMaxState) return kErrStateDim;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, A, B, C, D, s0, y, s_out, b, s,
                                   di, n, st);
  return launch_n<float>(x, dt, A, B, C, D, s0, y, s_out, b, s, di, n, st);
}

const char* ssm_scan_error_string(int code) {
  if (code == kErrStateDim) return "state dim n outside 1..16";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
