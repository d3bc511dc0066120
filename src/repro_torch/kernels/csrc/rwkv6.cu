// The RWKV-6 WKV recurrence on Hopper, written by hand.
//
// Replaces _wkv_kernel in src/repro/kernels/rwkv6_kernel.py (called through
// rwkv6 there). Same function: r, k, v, w [b, s, h, n] (float32 or
// bfloat16, one type; w the decay, already exp(-exp(.)) in (0, 1)), u [h, n]
// float32, state [b, h, n, n] float32 (key x value; zeros when none is
// passed); per (batch, head) and step, in float32,
//   o_j = sum_i r_i (S_ij + u_i k_i v_j),   S_ij <- w_i S_ij + k_i v_j,
// out [b, s, h, n] in r's type and the final state [b, h, n, n] float32:
// the recurrence of the reference's oracle (ref.rwkv6_scan). Both kernels
// below take any s >= 1, head dims 16, 32 and 64, and a state passed in,
// which they do not modify (the state out is a separate buffer), so a run
// split at any step equals one whole run. The wrapper runs wkv_chunked
// for s >= 64 (prefill) and wkv_kernel for shorter runs and decode.
//
// wkv_chunked: chunks of 32 steps as matrix products on the tensor cores.
// With c_t the chunk-local inclusive cumulative sum of log2 w (float32,
// from the chunk start, so magnitudes stay small) and S0 the state at the
// chunk start, a chunk is
//   inter  o_t += (r_t * 2^c_{t-1}) S0
//   intra  o_t += sum_{s<t} (sum_i r_ti k_si 2^(c_{t-1,i} - c_si)) v_s
//   bonus  o_t += (r_t . (u * k_t)) v_t
//   state  S1 = diag(2^c_31) S0 + sum_s (k_s * 2^(c_31 - c_s)) v_s^T.
// Every decay factor is <= 1 by construction. The intra pairs are split
// into sub-blocks of 8 steps: a key sub-block before the query sub-block
// starting at q0 factors around q0 - 1 as 2^(c_{t-1} - c_{q0-1}) times
// 2^(c_{q0-1} - c_s), both <= 1, so nothing overflows and a factor
// underflows only where the true weight does; the four 8 x 8 diagonal
// sub-blocks take their pair weights elementwise (the bonus is their
// diagonal). This is what the TPU kernel's exponent clamp could not do at
// strong decays (ROADMAP C10). Sub-blocks of 8 rather than 16: the
// elementwise pairs (an exp2 and a multiply-add per pair and key, read
// from shared memory) were the largest part of a chunk at 16, and 8
// halves them while the off-diagonal blocks move to the tensor cores.
//
// One block of eight warps owns one (batch, head) and walks its chunks in
// order. The state stays in the registers of the warps that own its tiles
// (and in shared memory as the next chunk's operand). The next chunk's r,
// k, v, w are prefetched with cp.async while the current one computes. A
// chunk is three phases between block barriers: (1) per key column and
// segment of steps, convert, log2 w, the cumulative sums (a segment's
// sum, then those of the segments before it, added in order, so every
// thread forms a given c bitwise alike and a factor whose exponent is 0
// is exactly 1) and the factors of inter and state; (2) the diagonal
// pairs, the off-diagonal pair blocks, inter and the state update; (3)
// the pairs times v into the output. The products run as
// mma.sync.m16n8k8 in TF32 with the 3xTF32 split (a = hi + lo; hi hi +
// hi lo + lo hi, float32 accumulate): plain TF32 (2^-11) could not hold
// the state to float32's 1e-5. v is split once as it is staged; a bf16 v
// is exact in TF32, so its products drop the hi lo term. mma.sync, not
// wgmma: a TF32 wgmma needs both operands K-major in shared memory, and
// these products reduce along three axes of the same tiles (key, step,
// value), so each operand needs a transposed, swizzled TF32 copy (hi and
// lo) per chunk; a build that ran the 64-row products (state, inter,
// intra) as TF32 wgmma from such copies measured no faster on the H100,
// since the per-chunk phases around the products set the time.
// w is floored at FLT_MIN before its log (a decay below 1e-38 a step
// leaves nothing of the state either way).
//
// wkv_kernel: the exact per-step recurrence. One block owns one (batch,
// head) and runs the whole time loop with the state in registers: 4n
// threads, four to a value column j, each holding the n/4 key rows of
// S_ij it owns. A step is o_j = sum_i r_i S_ij + v_j (sum_i r_i u_i k_i),
// so the bonus is one dot product per step. The block stages r, k, w and
// v of 32 steps at a time in shared memory as float32; each thread reads
// its rows back as float4 broadcasts, does 5 float32 operations per state
// element, and the four threads of a column sum their parts by two
// shuffles. Decode (s = 1) runs it with one step.
//
// What bounds it on the H100. At the serving path's prefill (b 4, s
// 2,048, h 64, n 64, bf16) the function must move r, k, v, w and out in
// bf16 and the state out in float32: 0.34 GB, 0.101 ms at 3.35 TB/s. The
// chunked form's products are 2 n^2 + 40.5 n multiply-adds a step, 10.8
// GFLOP over the prefill: 0.022 ms at the 495 TFLOP/s TF32 peak, counting
// the 3xTF32 split once. So the function is bound by bytes. The chunked
// kernel is far from that bound: with two 256-thread blocks an SM, its
// time goes to the per-chunk phases themselves (the cumulative sums,
// the factors and pairs on the CUDA cores, the mma.sync dispatch) and the
// four block barriers a chunk. The per-step kernel's 5 n^2 float32
// operations a step bind it at 0.163 ms (operations, 67 TFLOP/s); its
// serial chain of steps, not instruction throughput, sets its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------
// wkv_chunked: 32-step chunks, 3xTF32 products on the tensor cores.

constexpr int kChunk = 32;               // steps a chunk
constexpr int kSub = 8;                  // steps a sub-block
constexpr int kPairs = kSub * (kSub - 1) / 2;   // pairs s < t of a sub-block
constexpr int kCThreads = 256;
constexpr int kCWarps = kCThreads / 32;

// shared-memory plan, in floats. Row strides: LA (= 4 mod 32) for tiles
// read as [fragment row][k], LB (= 8 mod 32) for tiles read as
// [k][fragment column], so a warp's fragment loads hit 32 distinct banks.
template <typename T, int N>
struct Plan {
  static constexpr int LA = N + 4, LB = N + 8, LM = kChunk + 4;
  static constexpr int LV = N + 4;    // v (hi, lo) pairs a row: = 4 mod 16
  static constexpr int rf = 0;                        // r       [C][LA]
  static constexpr int kf = rf + kChunk * LA;         // k       [C][LA]
  static constexpr int c = kf + kChunk * LA;          // cum log2 w [C][LA]
  static constexpr int rin = c + kChunk * LA;         // inter r [C][LA]
  static constexpr int ks = rin + kChunk * LA;        // state k [C][LB]
  static constexpr int v = ks + kChunk * LB;  // v as TF32 (hi, lo) [C][LV]
  static constexpr int s = v + 2 * kChunk * LV;       // state   [N][LB]
  static constexpr int a = s + N * LB;                // pairs   [C][LM]
  static constexpr int decay = a + kChunk * LM;       // [N]
  static constexpr int u = decay + N;                 // [N]
  static constexpr int tot = u + N;     // segment sums of log2 w [SEG][N]
  static constexpr int stage = tot + 256;   // r, k, v, w, raw [4][C][N]
  static constexpr size_t bytes = stage * sizeof(float) +
                                  4 * kChunk * N * sizeof(T);
  static_assert(stage % 4 == 0, "the stage must be 16-byte aligned");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

// 2^x in one special-function instruction; results below 2^-126 flush
// to zero (a decay weight that small is nothing at float32's tolerance)
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a float as a TF32 high part (rounded to nearest on its 10 mantissa
// bits: add half a TF32 step, clear the low 13 bits) and the exact
// remainder, which the tensor core reads as TF32 by ignoring its low 13
// bits: three instructions, where cvt.rna.tf32.f32 takes five. The
// remainder is at most 2^-11 of x and loses at most 2^-10 of itself, so
// a product of split operands is within ~2^-20 of the float32 one.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[x] (a 16 x 8 tile, mma layout) += A[16 rows][K] B[K][8 x + 8 cols]
// for x < NT, in 3xTF32: hi hi into acc, the cross terms into a second
// sum (two independent chains), added at the end. a(row, k) reads A;
// b(k, col) gives B's (hi, lo) TF32 parts. With B_EXACT (B's low parts
// are zero: v from bf16, whose 8 mantissa bits fit TF32's 10) the hi lo
// term is left out.
template <int NT, int K, bool B_EXACT, class FA, class FB>
__device__ __forceinline__ void mma3(float (&acc)[NT][4], FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float cross[NT][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a(g, k0 + q), ah[0], al[0]);
    split_tf32(a(g + 8, k0 + q), ah[1], al[1]);
    split_tf32(a(g, k0 + q + 4), ah[2], al[2]);
    split_tf32(a(g + 8, k0 + q + 4), ah[3], al[3]);
#pragma unroll
    for (int x = 0; x < NT; ++x) {
      const uint2 b0 = b(k0 + q, 8 * x + g), b1 = b(k0 + q + 4, 8 * x + g);
      const uint32_t bh[2] = {b0.x, b1.x}, bl[2] = {b0.y, b1.y};
      mma_tf32(cross[x], al, bh);
      if (!B_EXACT) mma_tf32(cross[x], ah, bl);
      mma_tf32(acc[x], ah, bh);
    }
  }
#pragma unroll
  for (int x = 0; x < NT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] += cross[x][e];
}

// B's (hi, lo) TF32 parts from a float
__device__ __forceinline__ uint2 split2(float x) {
  uint2 r;
  split_tf32(x, r.x, r.y);
  return r;
}

template <typename T, int N>
__global__ void __launch_bounds__(kCThreads, 2)
wkv_chunked(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ out, float* __restrict__ s_out, int s, int h) {
  using P = Plan<T, N>;
  constexpr int LA = P::LA, LB = P::LB, LM = P::LM, LV = P::LV;
  constexpr int NB = N / 8;                     // 8-column tiles of a row
  // state tiles (16 x 8) and output tiles (of C x N) per warp
  constexpr int kStateTiles = (N / 16) * NB;
  constexpr int kOutTiles = (kChunk / 16) * NB;
  constexpr int NTS = kStateTiles / kCWarps > 0 ? kStateTiles / kCWarps : 1;
  constexpr int NTO = kOutTiles / kCWarps > 0 ? kOutTiles / kCWarps : 1;
  static_assert(NB % NTS == 0 && NB % NTO == 0, "head dim");
  // the first pass: SEG threads to a key column, L consecutive steps each
  constexpr int SEG = kCThreads / N;
  constexpr int L = kChunk / SEG;
  static_assert(SEG * N == kCThreads && L * SEG == kChunk && SEG * N <= 256,
                "head dim");
  constexpr int G = N * (int)sizeof(T) / 16;    // 16-byte pieces of a row
  constexpr bool kVExact = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float sm[];
  float* rf = sm + P::rf;
  float* kf = sm + P::kf;
  float* cs = sm + P::c;
  float* rin = sm + P::rin;
  float* ks = sm + P::ks;
  uint2* vs = reinterpret_cast<uint2*>(sm + P::v);
  float* ss = sm + P::s;
  float* am = sm + P::a;
  float* decay = sm + P::decay;
  float* us = sm + P::u;
  float* tot = sm + P::tot;
  T* stage = reinterpret_cast<T*>(sm + P::stage);

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh - batch * h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const size_t pitch = (size_t)h * N;     // one step in [b, s, h, n]
  const size_t base = ((size_t)batch * s * h + head) * N;
  const size_t sbase = (size_t)bh * N * N;

  auto prefetch = [&](int t0) {
    const int steps = min(kChunk, s - t0);
    for (int idx = tid; idx < 4 * steps * G; idx += kCThreads) {
      const int which = idx / (steps * G), rem = idx % (steps * G);
      const int t = rem / G, piece = rem % G;
      const T* src = which == 0 ? r : which == 1 ? k : which == 2 ? v : w;
      cp_async16(stage + (which * kChunk + t) * N + piece * (16 / sizeof(T)),
                 src + base + (size_t)(t0 + t) * pitch +
                     piece * (16 / sizeof(T)));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  prefetch(0);

  // the state: tiles of the warps that own them, and in shared memory
  const int ts0 = warp * NTS;
  const bool owns_state = ts0 < kStateTiles;
  const int srow = (ts0 / NB) * 16, scol = (ts0 % NB) * 8;
  float st[NTS][4];
#pragma unroll
  for (int x = 0; x < NTS; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = srow + g + 8 * (e >> 1), j = scol + 8 * x + 2 * q + (e & 1);
      st[x][e] = (s0 && owns_state) ? s0[sbase + (size_t)i * N + j] : 0.f;
    }
  for (int idx = tid; idx < N * N; idx += kCThreads)
    ss[(idx / N) * LB + idx % N] = s0 ? s0[sbase + idx] : 0.f;
  for (int i = tid; i < N; i += kCThreads) us[i] = u[head * N + i];
  // the output tiles of this warp: rows orow .. + 15, columns ocol ..
  const int to0 = warp * NTO;
  const bool owns_out = to0 < kOutTiles;
  const int orow = (to0 / NB) * 16, ocol = (to0 % NB) * 8;
  // this thread's key column and steps in the first pass: a warp's lanes
  // take neighbouring columns, so its shared-memory accesses do not
  // conflict
  const int col = tid % N, seg = tid / N;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int steps = min(kChunk, s - t0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();          // the stage is in; the last chunk is done

    // first pass: convert, log2 w and its sum down the key column within
    // the segment; then each segment adds the sums of those before it,
    // in order, so that every thread forms any c value (step 15's, the
    // last step's) bitwise as its owner does and a factor whose exponent
    // is 0 is exactly 1; then every decay factor, all <= 1
    float rr[L], kk[L], c[L];
#pragma unroll
    for (int tt = 0; tt < L; ++tt) {
      // every step is read and computed (rows past s hold stale values)
      // and then selected, so the L steps' loads and log2 chains overlap
      const int t = seg * L + tt;
      const bool live = t < steps;            // past s: no step
      const float lw = log2f(fmaxf(
          to_f32(stage[(3 * kChunk + t) * N + col]), FLT_MIN));
      const float r_ = to_f32(stage[t * N + col]);
      const float k_ = to_f32(stage[(kChunk + t) * N + col]);
      const float v_ = to_f32(stage[(2 * kChunk + t) * N + col]);
      rr[tt] = live ? r_ : 0.f;
      kk[tt] = live ? k_ : 0.f;
      const float vv = live ? v_ : 0.f;
      c[tt] = (tt ? c[tt - 1] : 0.f) + (live ? lw : 0.f);
      vs[t * LV + col] = split2(vv);
      rf[t * LA + col] = rr[tt];
      kf[t * LA + col] = kk[tt];
    }
    tot[seg * N + col] = c[L - 1];
    __syncthreads();
    float excl = 0.f, cl = 0.f;
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      if (j == seg) excl = cl;
      cl += tot[j * N + col];
    }
#pragma unroll
    for (int tt = 0; tt < L; ++tt) c[tt] += excl;
#pragma unroll
    for (int tt = 0; tt < L; ++tt) {
      const int t = seg * L + tt;
      const float cp = tt ? c[tt - 1] : excl;
      cs[t * LA + col] = c[tt];
      rin[t * LA + col] = rr[tt] * fexp2(cp);
      ks[t * LB + col] = kk[tt] * fexp2(cl - c[tt]);
    }
    if (seg == 0) decay[col] = fexp2(cl);
    __syncthreads();
    if (t0 + kChunk < s) prefetch(t0 + kChunk);

    // the diagonal sub-blocks' pairs: s < t elementwise (their s > t
    // pairs are zero), then s == t, the bonus
    for (int p = tid; p < kChunk / kSub * kPairs + kChunk; p += kCThreads) {
      if (p < kChunk / kSub * kPairs) {
        const int sb = p / kPairs, pq = p % kPairs;
        int tl = (int)((1.f + sqrtf(8.f * pq + 1.f)) * 0.5f);
        while (tl * (tl - 1) / 2 > pq) --tl;
        while ((tl + 1) * tl / 2 <= pq) ++tl;
        const int t = sb * kSub + tl, sp = sb * kSub + pq - tl * (tl - 1) / 2;
        const float4* r4 = reinterpret_cast<const float4*>(rf + t * LA);
        const float4* k4 = reinterpret_cast<const float4*>(kf + sp * LA);
        const float4* ct4 = reinterpret_cast<const float4*>(cs + (t - 1) * LA);
        const float4* cs4 = reinterpret_cast<const float4*>(cs + sp * LA);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const float4 a = r4[i], b = k4[i], x = ct4[i], y = cs4[i];
          acc0 = fmaf(a.x * b.x, fexp2(x.x - y.x), acc0);
          acc1 = fmaf(a.y * b.y, fexp2(x.y - y.y), acc1);
          acc0 = fmaf(a.z * b.z, fexp2(x.z - y.z), acc0);
          acc1 = fmaf(a.w * b.w, fexp2(x.w - y.w), acc1);
        }
        am[t * LM + sp] = acc0 + acc1;
        am[sp * LM + t] = 0.f;
      } else {
        const int t = p - kChunk / kSub * kPairs;
        const float4* r4 = reinterpret_cast<const float4*>(rf + t * LA);
        const float4* k4 = reinterpret_cast<const float4*>(kf + t * LA);
        const float4* u4 = reinterpret_cast<const float4*>(us);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const float4 a = r4[i], b = k4[i], c4 = u4[i];
          acc0 = fmaf(a.x * c4.x, b.x, acc0);
          acc1 = fmaf(a.y * c4.y, b.y, acc1);
          acc0 = fmaf(a.z * c4.z, b.z, acc0);
          acc1 = fmaf(a.w * c4.w, b.w, acc1);
        }
        am[t * LM + t] = acc0 + acc1;
      }
    }
    // the pairs s > t of the 16-row tiles the intra product reads that
    // lie outside the diagonal sub-blocks are zero
    for (int z = tid; z < kChunk / 16 * kSub * kSub; z += kCThreads) {
      const int m0 = 16 * (z / (kSub * kSub)), zz = z % (kSub * kSub);
      am[(m0 + zz / kSub) * LM + m0 + kSub + zz % kSub] = 0.f;
    }
    // the off-diagonal pair blocks: the queries of sub-block qb (1..3)
    // against each earlier key sub-block nt, factored around the query
    // sub-block's start q0 as r 2^(c_{t-1} - c_{q0-1}) times
    // k 2^(c_{q0-1} - c_s), both <= 1, formed as they are read; one
    // 8 x 8 block a warp, as an m16n8k8 product whose rows 8..15 are 0
    if (warp < kChunk / kSub * (kChunk / kSub - 1) / 2) {
      int qb = 1, nt = warp;
      while (nt >= qb) nt -= qb++;
      const int t = qb * kSub + g, sk0 = nt * kSub;
      const float* cref = cs + (qb * kSub - 1) * LA;
      float acc[4] = {}, cross[4] = {};
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 8) {
        uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = k0 + q + 4 * h2;
          split_tf32(rf[t * LA + i] * fexp2(cs[(t - 1) * LA + i] - cref[i]),
                     ah[2 * h2], al[2 * h2]);
          split_tf32(kf[(sk0 + g) * LA + i] *
                         fexp2(cref[i] - cs[(sk0 + g) * LA + i]),
                     bh[h2], bl[h2]);
        }
        mma_tf32(cross, al, bh);
        mma_tf32(cross, ah, bl);
        mma_tf32(acc, ah, bh);
      }
      am[t * LM + sk0 + 2 * q] = acc[0] + cross[0];
      am[t * LM + sk0 + 2 * q + 1] = acc[1] + cross[1];
    }
    // inter: o = (r 2^c) S0
    float o[NTO][4] = {};
    if (owns_out)
      mma3<NTO, N, false>(
          o, [&](int i, int kx) { return rin[(orow + i) * LA + kx]; },
          [&](int kx, int j) { return split2(ss[kx * LB + ocol + j]); });
    // state: S1 = diag(2^c_31) S0 + (k 2^(c_31 - c))^T v, in registers
    if (owns_state) {
#pragma unroll
      for (int x = 0; x < NTS; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[x][e] *= decay[srow + g + 8 * (e >> 1)];
      mma3<NTS, kChunk, kVExact>(
          st, [&](int i, int kx) { return ks[kx * LB + srow + i]; },
          [&](int kx, int j) { return vs[kx * LV + scol + j]; });
    }
    __syncthreads();          // the pair block is whole; S0 is read
    if (owns_out) {
      // intra and bonus: o += pairs v, keys up to the tile's last query
      auto pa = [&](int i, int kx) { return am[(orow + i) * LM + kx]; };
      auto pv = [&](int kx, int j) { return vs[kx * LV + ocol + j]; };
      if (orow == 0) mma3<NTO, 16, kVExact>(o, pa, pv);
      else mma3<NTO, kChunk, kVExact>(o, pa, pv);
#pragma unroll
      for (int x = 0; x < NTO; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = orow + g + 8 * (e >> 1);
          if (t < steps)
            out[base + (size_t)(t0 + t) * pitch + ocol + 8 * x + 2 * q +
                (e & 1)] = from_f32<T>(o[x][e]);
        }
    }
    if (owns_state)
#pragma unroll
      for (int x = 0; x < NTS; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ss[(srow + g + 8 * (e >> 1)) * LB + scol + 8 * x + 2 * q +
             (e & 1)] = st[x][e];
  }
  if (owns_state)
#pragma unroll
    for (int x = 0; x < NTS; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_out[sbase + (size_t)(srow + g + 8 * (e >> 1)) * N + scol + 8 * x +
              2 * q + (e & 1)] = st[x][e];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_out, int b,
           int s, int h, int chunked, cudaStream_t stream) {
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  const float* uu = static_cast<const float*>(u);
  const float* ss = static_cast<const float*>(s0);
  if (chunked) {
    const size_t bytes = Plan<T, N>::bytes;
    static const cudaError_t attr = cudaFuncSetAttribute(
        wkv_chunked<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (attr != cudaSuccess) return (int)attr;
    wkv_chunked<T, N><<<b * h, kCThreads, bytes, stream>>>(
        rr, kk, vv, ww, uu, ss, static_cast<T*>(out),
        static_cast<float*>(s_out), s, h);
  } else {
    wkv_kernel<T, N><<<b * h, kSplit * N, 0, stream>>>(
        rr, kk, vv, ww, uu, ss, static_cast<T*>(out),
        static_cast<float*>(s_out), s, h);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* out, void* s_out, int b,
             int s, int h, int n, int chunked, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                  chunked, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                  chunked, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                  chunked, stream);
    default: return kErrHeadDim;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (r, k, v, w and out). s0 may be null (a
// zero state). chunked 0 runs wkv_kernel (per step), 1 wkv_chunked.
// Returns a cudaError_t, or 1000 for a head dim n other than 16, 32 or
// 64. r, k, v and w must be 16-byte aligned for wkv_chunked's cp.async.
int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* out, void* s_out,
                 int dtype, int b, int s, int h, int n, int chunked,
                 void* stream) {
  if (n != 16 && n != 32 && n != 64) return kErrHeadDim;
  if (b <= 0 || h <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(r, k, v, w, u, s0, out, s_out, b, s, h,
                                   n, chunked, st);
  return launch_n<float>(r, k, v, w, u, s0, out, s_out, b, s, h, n, chunked,
                         st);
}

const char* rwkv6_error_string(int code) {
  if (code == kErrHeadDim) return "head dim n other than 16, 32 or 64";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
