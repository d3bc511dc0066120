// The Mamba-1 selective scan on Hopper, written by hand.
//
// Replaces _ssm_kernel in src/repro/kernels/ssm_scan.py. Same function:
// x, dt [b, s, di] and B, C [b, s, n] (float32 or bfloat16), A [di, n] and
// D [di] float32, state [b, di, n] float32 (zeros when none is passed);
// per channel and step, in float32,
//   h = exp(dt * A) * h + (dt * x) * B,   y = sum_n h * C + D * x,
// y [b, s, di] in x's type and the final state [b, di, n] float32.
//
// What bounds it on the H100. At the serving path's prefill (b 4, s 2,048,
// di 16,384, n 16, bf16) the kernel must move 0.81 GB (x, dt and y,
// 0.27 GB each): 0.24 ms at 3.35 TB/s, bound by bytes. But it also takes
// 2.15 G exponentials, one per state element, and the card's special
// function units (MUFU) give 16 a clock on each SM: 0.51 ms at the
// 1.98 GHz the card runs under load. That is the floor of a design that
// sends every exp to the MUFU. The rest of a state element's work is four
// float32 instructions (dt * A, the product and fma of the update, the
// fma into y) and a share of the shared-memory reads of B and C, about as
// much issue again (~119 instructions a channel-step, ~0.48 ms), so the
// two pipes' floors are about equal.
//
// Design. The TPU kernel walks a (batch, channel block, time chunk) grid
// with time in order and keeps the [d_blk, n] state in VMEM scratch across
// chunks. Here one thread owns one (batch, channel) and runs the whole
// time loop, its n <= 16 states in registers from the first step to the
// last. A block is 128 neighbouring channels of one batch row. Time runs
// in chunks of 32 bf16 (16 float32) steps, double-buffered in shared
// memory: the chunk's x and dt tiles come by cp.async in 16-byte pieces,
// its B and C (the same for every channel of a batch row) are loaded into
// registers and stored as float32, both for chunk c + 1 while chunk c
// runs, with one barrier a chunk; threads read B and C back as
// broadcasts. Each exp is exp2(dt * A2), A2 = A * log2(e) scaled once per
// channel in the prologue, so it is one MUFU.EX2 (ex2.approx.ftz, 2 ulp)
// with no range fix-up, where expf took about six more instructions. The
// MUFU and the issue of the rest are two floors of about the same height,
// so neither moving exps onto the FMA pipe by a polynomial nor splitting
// a channel over more lanes (more warps, shuffles for y) pays: both
// measured slower. y's sum runs in four interleaved partial sums, so that
// its chain of fused multiply-adds is four deep, not sixteen. A decode
// step (s = 1) is the same kernel with one step. The state out is a
// separate buffer, so a state passed in is not modified, and a run split
// anywhere with the state carried across equals one whole run: nothing
// depends on where a chunk starts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // channels a block, one a thread
constexpr int kSums = 4;               // partial sums of a channel's y
constexpr int kMaxState = 16;
constexpr int kErrStateDim = 1000;
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x on the MUFU: one instruction, denormal results flushed to zero.
__device__ __forceinline__ float ex2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of 16 bytes from device to shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int N>
struct Plan {
  static constexpr int kChunk = 64 / sizeof(T);           // steps a chunk
  static constexpr int kVec = 16 / sizeof(T);             // x per 16 bytes
  // B, C elements of a chunk each thread stages
  static constexpr int kStage = (kChunk * N + kThreads - 1) / kThreads;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ D,
                const float* __restrict__ s0, T* __restrict__ y,
                float* __restrict__ s_out, int s, int di, int vec16) {
  using P = Plan<T, N>;
  constexpr int kChunk = P::kChunk, kVec = P::kVec, kStage = P::kStage;
  __shared__ __align__(16) T xs[2][kChunk][kThreads];
  __shared__ __align__(16) T ds[2][kChunk][kThreads];
  __shared__ __align__(16) float bs[2][kChunk][N];
  __shared__ __align__(16) float cs[2][kChunk][N];
  const int batch = blockIdx.y;
  const int col = threadIdx.x;                 // this thread's channel column
  const int ch0 = blockIdx.x * kThreads;
  const int ch = ch0 + col;
  const bool live = ch < di;
  // a thread past di computes on the last channel (it still stages its
  // share of the tiles) and stores nothing
  const int chl = live ? ch : di - 1;

  float a2[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a2[j] = A[(size_t)chl * N + j] * kLog2e;
    h[j] = s0 ? s0[((size_t)batch * di + chl) * N + j] : 0.f;
  }
  const float d_skip = D[chl];

  // x and dt of a chunk: [steps][kThreads] tiles, by cp.async in 16-byte
  // pieces (a piece lies wholly inside or wholly past di when vec16),
  // else element by element
  auto load_xdt = [&](int t0, int buf) {
    const int steps = min(kChunk, s - t0);
    const size_t row0 = (size_t)batch * s + t0;
    if (vec16) {
      constexpr int kRow = kThreads / kVec;
      for (int idx = threadIdx.x; idx < steps * kRow; idx += kThreads) {
        const int r = idx / kRow, c = (idx % kRow) * kVec;
        if (ch0 + c < di) {
          const size_t g = (row0 + r) * di + ch0 + c;
          cp_async16(&xs[buf][r][c], x + g);
          cp_async16(&ds[buf][r][c], dt + g);
        }
      }
      cp_async_commit();
    } else {
      for (int idx = threadIdx.x; idx < steps * kThreads; idx += kThreads) {
        const int r = idx / kThreads, c = idx % kThreads;
        if (ch0 + c < di) {
          const size_t g = (row0 + r) * di + ch0 + c;
          xs[buf][r][c] = x[g];
          ds[buf][r][c] = dt[g];
        }
      }
    }
  };
  // B and C of a chunk: loaded into registers (`fetch`) while the chunk
  // before runs, stored as float32 after it (`stage`)
  float rb[kStage], rc[kStage];
  auto fetch = [&](int t0) {
    const int avail = min(kChunk, s - t0) * N;
    const size_t base = ((size_t)batch * s + t0) * N;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int idx = threadIdx.x + k * kThreads;
      rb[k] = idx < avail ? to_f32(B[base + idx]) : 0.f;
      rc[k] = idx < avail ? to_f32(C[base + idx]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int idx = threadIdx.x + k * kThreads;
      if (idx < kChunk * N) {
        bs[buf][idx / N][idx % N] = rb[k];
        cs[buf][idx / N][idx % N] = rc[k];
      }
    }
  };
  load_xdt(0, 0);
  fetch(0);
  stage(0);

  for (int t0 = 0, buf = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();                    // this chunk's tiles are in `buf`
    const int steps = min(kChunk, s - t0);
    const bool more = t0 + kChunk < s;
    if (more) {                         // in flight while this chunk runs
      load_xdt(t0 + kChunk, buf ^ 1);
      fetch(t0 + kChunk);
    }
#pragma unroll 4
    for (int tt = 0; tt < steps; ++tt) {
      const float xv = to_f32(xs[buf][tt][col]);
      const float dv = to_f32(ds[buf][tt][col]);
      const float dx = dv * xv;
      const float* bt = bs[buf][tt];
      const float* ct = cs[buf][tt];
      float part[kSums] = {};           // y's sum in kSums short chains
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h[j] = fmaf(ex2_mufu(dv * a2[j]), h[j], dx * bt[j]);
        part[j % kSums] = fmaf(h[j], ct[j], part[j % kSums]);
      }
      const float acc = (part[0] + part[1]) + (part[2] + part[3]);
      if (live)
        y[((size_t)batch * s + t0 + tt) * di + ch] =
            from_f32<T>(acc + d_skip * xv);
    }
    if (more) stage(buf ^ 1);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < N; ++j) s_out[((size_t)batch * di + ch) * N + j] = h[j];
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, const void* s0, void* y,
           void* s_out, int b, int s, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, b);
  const int vec16 = di % Plan<T, N>::kVec == 0 &&
                    (reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(dt)) % 16 == 0;
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<T*>(y),
      static_cast<float*>(s_out), s, di, vec16);
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
