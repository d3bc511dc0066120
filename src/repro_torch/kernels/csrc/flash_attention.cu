// Forward attention on Hopper, written by hand: grouped-query heads,
// causal or not, with an online softmax over key/value tiles.
//
// Replaces _flash_kernel in src/repro/kernels/flash_attention.py. Same
// function: q [b, sq, h, dqk], k [b, sk, kh, dqk], v [b, sk, kh, dv]
// (float32 or bfloat16), query head i reads kv head i / (h / kh), out
// [b, sq, h, dv] in q's type; scores, running max m, denominator l and the
// output sum in float32; masked scores -1e30, causal as qpos >= kpos
// counted from position 0; keys past sk weigh 0; the denominator floored
// at 1e-30 before the final division. Any sq and sk. Head dims: dqk and
// dv each a multiple of 8 from 8 to 256, equal or not (MLA's 96 / 64); the
// Pallas kernel takes any (ROADMAP C17). Multiples of 8 are TMA's rule:
// a tensor map's row stride must be a multiple of 16 bytes.
//
// Two kernels, chosen by type. Both give one thread block one (batch x
// head, q tile) and run the kv loop inside it, so m, l and the output sum
// never leave registers (the TPU kernel carries them in VMEM buffers
// across a sequential kv grid axis). Causal grids start with the q tiles
// that have the most kv tiles to walk; tiles wholly above the diagonal
// are never loaded.
//
// Head dims are padded in shared memory and registers only, to a storage
// dim: 16, 32 or 64 up to 64, else the next multiple of 64 (24 -> 32; 80
// and 96 -> 128; 256 stays). Loads fill the columns past the real dim
// with zeros, so the padded q and k columns add exact zeros to S = QK^T
// and the padded output columns, never stored, are zero: the result is
// the unpadded arithmetic. The bf16 kernel is a template on both storage
// dims (36 pairs), the float32 one on dv's (its q/k loop runs to dqk).
//
// bfloat16: flash_wgmma_kernel<DQ, DV>, on the tensor cores. A block is
// three warpgroups: a producer and two consumers of 64 query rows each (a
// 128-row q tile). Twelve warps put three on each of an SM's four
// register files, which caps a thread at 168 registers; the producer
// gives up all but 40 of its own (setmaxnreg) so that each consumer thread
// holds 232, room for dv = 256's 128-register output sum without spills.
// The producer's elected thread loads
// the q tile once and then KEYS-key K and V tiles into a ring of two
// stages with TMA (4-D tensor maps over [b, s, heads, d] whose innermost
// extent is the real head dim, so TMA itself writes the zero columns past
// it, and rows past s arrive as zeros and never cross into the next batch
// row), in the 128-, 64- or 32-byte swizzled layout wgmma reads (a
// 64-column block per 128-byte row at storage dims >= 64), completing on
// an mbarrier per stage; consumers release a stage with a second
// mbarrier. KEYS is 128, or 64 when either storage dim passes 128: at
// dqk = dv = 256 a 128-row q tile and two stages of 128-key K and V would
// take 320 KB of shared memory, at 64 keys 192 KB. A consumer warpgroup
// computes S = Q K^T with wgmma m64n{KEYS}k16 (bf16 in, float32
// accumulate, both operands from shared memory), scales, masks (only a
// tile on the diagonal or past sk), and keeps the running max and
// denominator in float32 registers; a row lives in the four lanes of a
// quad, so its max and sum are two xor shuffles. P = exp2(S - m) is
// rounded to bf16 in registers, where the S accumulator's layout is
// already the A-operand layout, and O += P V runs as wgmma m64n{DV}k16 with
// A from registers and V from shared memory as a transposed (MN-major) B
// operand. The denominator sums the float32 p. Rounding P to bf16 departs
// from the Pallas kernel, which keeps P in float32 (ROADMAP C8): at most
// one bf16 rounding (2^-9 relative) per term of the PV sum, inside the
// bf16 output tolerance. Shared memory at dqk = dv = 128: 32 KB of q and
// 2 x 2 x 32 KB of K/V stages; at 256 / 256: 64 KB and 2 x 2 x 32 KB; one
// block (12 warps) an SM.
//
// float32: flash_fwd_kernel<DV>, on the CUDA cores (TF32 tensor cores
// would miss the float32 tolerance, and no full-width path runs float32
// attention). 128 threads own a 64-row q tile; thread (ty, tx) holds rows
// 4 ty .. 4 ty + 3 and scores keys tx + 8 j of a 64-key tile; q, k, v and
// the probability tile are staged in shared memory as float32, rows padded
// by one word where a warp reads down a column (209 KB at dqk = dv = 256).
//
// What bounds it on the H100. The causal prefill of the serving path
// (b 4, sq = sk 2,048, h 64, kh 8, d 128) is 275 GFLOP: at the tensor
// cores' 989 TFLOP/s that is 0.28 ms, against 0.09 ms for its 0.30 GB of
// q, k, v and out, so the bf16 kernel is bound by operations, as it is at
// every prefill shape of the configs. Its design overlaps the loads with
// the products (the ring, a producer of its own) but not yet the softmax
// of one tile with the products of the next (two warpgroups an SM
// interleave instead); that, an output written through registers rather
// than TMA, and the products spent on padding (37.5% of them at dqk = dv
// = 80) are what separate it from the bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <initializer_list>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kErrHeadDim = 1000;
constexpr int kErrLibcuda = 1001;
constexpr int kErrTensorMap = 1002;
constexpr int kErrAlign = 1003;

// the head-dim rule: a multiple of 8 from 8 to 256
__host__ __device__ constexpr bool head_dim_ok(int d) {
  return d >= 8 && d <= kMaxHeadDim && d % 8 == 0;
}
// the storage dim a head dim pads to: 16, 32 or 64 up to 64, else the
// next multiple of 64
__host__ __device__ constexpr int storage_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : (d + 63) / 64 * 64;
}

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kRows = kBlockQ / 16;      // query rows per thread
constexpr int kCols = kBlockK / 8;       // keys per thread per tile
constexpr float kNegInf = -1e30f;
static_assert(kBlockQ == kBlockK, "load_tile stages 64-row tiles of both");

// q and k rows of dq floats (+1 word), v rows of DV, the probability tile
constexpr size_t smem_bytes(int dq, int dv_storage) {
  return sizeof(float) * (kBlockQ * (dq + 1) + kBlockK * (dq + 1) +
                          kBlockK * dv_storage + kBlockQ * (kBlockK + 1));
}

// Copy rows [row0, row0 + 64) of one head of a [b, s, heads, d] tensor
// into a float tile of `cols` columns and row stride `ld`, zeros past `s`
// and past column d.
__device__ __forceinline__ void load_tile(float* tile, int ld, int cols,
                                          const float* __restrict__ src,
                                          int batch, int s, int heads,
                                          int head, int row0, int d) {
  for (int idx = threadIdx.x; idx < kBlockK * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    const int pos = row0 + r;
    float v = 0.f;
    if (pos < s && c < d) {
      v = src[(((size_t)batch * s + pos) * heads + head) * d + c];
    }
    tile[r * ld + c] = v;
  }
}

template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int h, int kh, int dq, int dv, float scale,
                 int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                              // [64][dq + 1]
  float* ks = qs + kBlockQ * (dq + 1);           // [64][dq + 1]
  float* vs = ks + kBlockK * (dq + 1);           // [64][DV]
  float* ps = vs + kBlockK * DV;                 // [64][65]

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

  load_tile(qs, dq + 1, dq, q, batch, sq, h, head, q0, dq);

  float m[kRows], l[kRows], acc[kRows][DV / 8];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) acc[i][j] = 0.f;
  }

  for (int jt = 0; jt < n_kv; ++jt) {
    const int k0 = jt * kBlockK;
    __syncthreads();                    // the last tile's reads are done
    load_tile(ks, dq + 1, dq, k, batch, sk, kh, kv_head, k0, dq);
    load_tile(vs, DV, DV, v, batch, sk, kh, kv_head, k0, dv);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < dq; ++dd) {
      float qr[kRows], kr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qr[i] = qs[(ty * kRows + i) * (dq + 1) + dd];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kr[j] = ks[(tx + 8 * j) * (dq + 1) + dd];
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
      for (int j = 0; j < DV / 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                    // the probability tile is whole

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = ps[(ty * kRows + i) * (kBlockK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const float vv = vs[kk * DV + tx + 8 * j];
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
    float* dst = o + (((size_t)batch * sq + qpos) * h + head) * dv;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      if (tx + 8 * j < dv) dst[tx + 8 * j] = acc[i][j] * inv_l;
  }
}

// ---------------------------------------------------------------------
// bf16: TMA + wgmma.

constexpr int kWgRows = 128;             // q tile: two warpgroups of 64
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kWgThreads = kConsumers + 128;  // + one producer warpgroup
// registers a thread after the producer warpgroup hands its own to the
// consumers (setmaxnreg): 128 x 40 + 256 x 232 = 384 x 168, the launch's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// one box of a 4-D tensor map {d, heads, s, b} into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// a warpgroup's register budget, set by all its threads together
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DV == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (DV == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (DV == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (DV == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (DV == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}
template <int KEYS>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (KEYS == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
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

// columns of one swizzle span at a storage dim (a row of it is 32, 64 or
// 128 bytes), and the span's layout code in a wgmma descriptor (1: 128 B,
// 2: 64 B, 3: 32 B)
__host__ __device__ constexpr int span_cols(int ds) {
  return ds < 64 ? ds : 64;
}
__host__ __device__ constexpr int swizzle_code(int ds) {
  return ds >= 64 ? 1 : (ds == 32 ? 2 : 3);
}
// keys a K/V tile holds: 64 once either storage dim passes 128
__host__ __device__ constexpr int wg_keys(int dqs, int dvs) {
  return (dqs > 128 || dvs > 128) ? 64 : 128;
}
// q tile, two K and two V stages, barriers, and slack to align the base
// to 1 KB
constexpr size_t wgmma_smem_bytes(int dqs, int dvs, int keys) {
  return (size_t)2 * (kWgRows * dqs + kStages * keys * (dqs + dvs)) + 64 +
         1024;
}
// DQ and DV: the q/k and v storage dims
template <int DQ, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int sq, int sk, int h,
                   int kh, int dv, float scale_log2, int causal) {
  constexpr int KEYS = wg_keys(DQ, DV);
  constexpr int colsq = span_cols(DQ);   // columns of one q/k span
  constexpr int rbq = 2 * colsq;         // bytes of a q/k row in one span
  constexpr int ncbq = DQ / colsq;       // column blocks of a q/k tile
  constexpr int swq = swizzle_code(DQ);
  constexpr int RBV = span_cols(DV) * 2; // bytes of a V row in one span
  constexpr int COLSV = RBV / 2;
  constexpr int NCBV = DV / COLSV;       // column blocks of a V tile
  constexpr int SWV = swizzle_code(DV);
  constexpr int qt = kWgRows * DQ * 2;   // bytes of the q tile
  constexpr int kt = KEYS * DQ * 2;      // bytes of a K stage
  constexpr int VT = KEYS * DV * 2;      // bytes of a V stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                    // [cb][128][colsq]
  uint8_t* ks = smem + qt;               // [stage][cb][KEYS][colsq]
  uint8_t* vs = ks + kStages * kt;       // [stage][cb][KEYS][COLSV]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * VT);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int qtile = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                           : (int)blockIdx.y;
  const int q0 = qtile * kWgRows;
  int n_kv = (sk + KEYS - 1) / KEYS;
  if (causal) {
    const int last = min(min(q0 + kWgRows, sq), sk) - 1;
    n_kv = min(n_kv, last / KEYS + 1);
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {               // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, qt);
      for (int cb = 0; cb < ncbq; ++cb)
        tma_load(qs + cb * kWgRows * rbq, &tq, qbar, cb * colsq, head, q0,
                 batch);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(&empty[st], ((j / kStages) - 1) & 1);
        mbar_expect_tx(&full[st], kt + VT);
        for (int cb = 0; cb < ncbq; ++cb)
          tma_load(ks + st * kt + cb * KEYS * rbq, &tk, &full[st],
                   cb * colsq, kv_head, j * KEYS, batch);
        for (int cb = 0; cb < NCBV; ++cb)
          tma_load(vs + st * VT + cb * KEYS * RBV, &tv, &full[st],
                   cb * COLSV, kv_head, j * KEYS, batch);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 .. + 63 of the q tile; this
  // thread's rows r0 and r0 + 8 of them, columns 8 i + 2 (lane % 4) + e
  regs_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int qpos[2] = {q0 + wg * 64 + r0, q0 + wg * 64 + r0 + 8};
  const int cpos = 2 * (lane % 4);
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const uint32_t q_base = smem_u32(qs) + wg * 64 * rbq;
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    const uint32_t k_base = smem_u32(ks + st * kt);
    const uint32_t v_base = smem_u32(vs + st * VT);

    float s[KEYS / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      const int cb = kk * 16 / colsq, off = (kk * 16 % colsq) * 2;
      wgmma_qk<KEYS>(s,
                     smem_desc(q_base + cb * kWgRows * rbq + off, 16,
                               8 * rbq, swq),
                     smem_desc(k_base + cb * KEYS * rbq + off, 16, 8 * rbq,
                               swq),
                     kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<KEYS / 2>(s);

    const int k0 = j * KEYS;
    const bool edge = (causal && k0 + KEYS - 1 > q0 + wg * 64) ||
                      k0 + KEYS > sk;
    // the row max of the raw scores (scale > 0 keeps the order); masked
    // scores become -1e30, past sk -inf, both before the scaling
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kpos = k0 + 8 * i + cpos + (e & 1);
          if (causal && kpos > qpos[e >> 1]) s[4 * i + e] = kNegInf;
          if (kpos >= sk) s[4 * i + e] = -CUDART_INF_F;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
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
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int i = 0; i < KEYS / 8; ++i) {
      // p = 2^(s scale log2(e) - m), one multiply-add and one exp2
      const float p0 = fexp2(fmaf(s[4 * i], scale_log2, -m[0]));
      const float p1 = fexp2(fmaf(s[4 * i + 1], scale_log2, -m[0]));
      const float p2 = fexp2(fmaf(s[4 * i + 2], scale_log2, -m[1]));
      const float p3 = fexp2(fmaf(s[4 * i + 3], scale_log2, -m[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      // keys 16 kk + (0..7) are a0/a1, 16 kk + (8..15) a2/a3
      pa[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
      pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      wgmma_pv<DV>(acc, pa[kk],
                   smem_desc(v_base + kk * 16 * RBV, KEYS * RBV, 8 * RBV,
                             SWV));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DV / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the real dv columns only (a multiple of 8: whole 8-column groups)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = o + (((size_t)batch * sq + qpos[r]) * h + head) * dv;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      if (8 * i < dv)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i + cpos) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv_l,
                                  acc[4 * i + 2 * r + 1] * inv_l);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda this process already loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a [b, s, heads, d] bf16 tensor as boxes of `rows` rows of one head and
// one swizzle span of the storage dim `ds`; the innermost extent is the
// real d, so TMA writes zeros to the span's columns past it
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int b, int s, int heads, int d, int ds, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)span_cols(ds), 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      ds >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (ds == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int b, int sq, int sk, int h, int kh, int dq, int dv,
                 float scale, int causal, cudaStream_t stream) {
  constexpr int KEYS = wg_keys(DQ, DV);
  constexpr size_t bytes = wgmma_smem_bytes(DQ, DV, KEYS);
  const cudaError_t attr = smem_opt_in(flash_wgmma_kernel<DQ, DV>,
                                       (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kErrAlign;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kErrLibcuda;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, b, sq, h, dq, DQ, kWgRows) ||
      !tensor_map(encode, &tk, k, b, sk, kh, dq, DQ, KEYS) ||
      !tensor_map(encode, &tv, v, b, sk, kh, dv, DV, KEYS))
    return kErrTensorMap;
  const dim3 grid(b * h, (sq + kWgRows - 1) / kWgRows);
  flash_wgmma_kernel<DQ, DV><<<grid, kWgThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, h, kh, dv,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

template <int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int h, int kh, int dq, int dv, float scale,
               int causal, cudaStream_t stream) {
  const cudaError_t attr = smem_opt_in(
      flash_fwd_kernel<DV>, (int)smem_bytes(kMaxHeadDim, DV));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b * h, (sq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<DV><<<grid, kThreads, smem_bytes(dq, DV), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, kh,
      dq, dv, scale, causal);
  return (int)cudaGetLastError();
}

// the bf16 kernel at q/k storage dim DQ and dv's storage dim
template <int DQ>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int h, int kh, int dq, int dv, float scale,
                int causal, cudaStream_t stream) {
#define FLASH_BF16(DV)                                                     \
  case DV:                                                                 \
    return launch_wgmma<DQ, DV>(q, k, v, o, b, sq, sk, h, kh, dq, dv,      \
                                scale, causal, stream)
  switch (storage_dim(dv)) {
    FLASH_BF16(16); FLASH_BF16(32); FLASH_BF16(64); FLASH_BF16(128);
    FLASH_BF16(192); FLASH_BF16(256);
  }
#undef FLASH_BF16
  return kErrHeadDim;
}

}  // namespace

extern "C" {

// dtype 0: float32 (flash_fwd_kernel), 1: bfloat16 (flash_wgmma_kernel).
// dq is the q/k head dim, dv the v head dim. Returns a cudaError_t, or
// 1000 for a head dim outside the rule (a multiple of 8 from 8 to 256),
// 1001 when libcuda has no cuTensorMapEncodeTiled, 1002 when a tensor map
// is refused, 1003 for bf16 operands not 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int b, int sq, int sk, int h,
                           int kh, int dq, int dv, float scale, int causal,
                           void* stream) {
  if (!head_dim_ok(dq) || !head_dim_ok(dv)) return kErrHeadDim;
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(D, FN)                                                  \
  case D:                                                                  \
    return FN<D>(q, k, v, o, b, sq, sk, h, kh, dq, dv, scale, causal, st)
  if (dtype == 1) {
    switch (storage_dim(dq)) {
      FLASH_CASE(16, launch_bf16); FLASH_CASE(32, launch_bf16);
      FLASH_CASE(64, launch_bf16); FLASH_CASE(128, launch_bf16);
      FLASH_CASE(192, launch_bf16); FLASH_CASE(256, launch_bf16);
    }
  } else {
    switch (storage_dim(dv)) {
      FLASH_CASE(16, launch_f32); FLASH_CASE(32, launch_f32);
      FLASH_CASE(64, launch_f32); FLASH_CASE(128, launch_f32);
      FLASH_CASE(192, launch_f32); FLASH_CASE(256, launch_f32);
    }
  }
#undef FLASH_CASE
  return kErrHeadDim;
}
const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrHeadDim:
      return "head dims must be multiples of 8 from 8 to 256";
    case kErrLibcuda: return "libcuda has no cuTensorMapEncodeTiled";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrAlign: return "bf16 operands must be 16-byte aligned";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
