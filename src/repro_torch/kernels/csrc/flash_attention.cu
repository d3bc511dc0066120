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
// dv each a multiple of 8 from 8, equal or not (MLA's 96 / 64, DeepSeek's
// absorbed 576 / 512). Multiples of 8 are TMA's rule: a tensor map's row
// stride must be a multiple of 16 bytes.
//
// Up to 256, two kernels, chosen by type; past 256 (either dim), two
// more, flash_wide_wgmma_kernel and flash_wide_f32_kernel (their note is
// at their code). The two give one thread block one (batch x head, q
// tile) and run the kv loop inside it, so m, l and the output sum
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
// dims (36 pairs). The float32 kernel stages and multiplies the real dims
// (whole 8-column groups); only its output sum's registers are sized by
// dv's storage dim, a template on it (6 kernels).
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
// float32: flash_f32_kernel<DV>, on the tensor cores in
// 3xTF32 (csrc/tf32_mma.cuh): a float x is split into a TF32 high part
// and the exact remainder, x = hi + lo, and a product is taken as lo hi +
// hi lo + hi hi by mma.sync.m16n8k8 with float32 accumulation, within
// ~2^-20 of the float32 product; one TF32 pass (2^-10) would miss the
// float32 tolerance of 1e-5. A block is four warps over a 64-row q tile,
// 16 rows a warp; m, l, S and the output sum live in the mma accumulator
// layout, a row in the four lanes of a quad (its max and sum two xor
// shuffles). The q tile is copied once; K and V tiles of 32 keys come by
// 16-byte cp.async into a ring of two stages, zero-filled past sk (no
// copy crosses into the next batch row), the next tile's copy in flight
// while this one's products run, one block barrier a tile. Each group of
// 8 dims (or keys) is multiplied in a permuted order, A's column q being
// element 2q of the group and its column q + 4 element 2q + 1 (the
// group's sum is the same): a lane's two q elements, and its two K
// elements, then lie side by side in a row (one 8-byte read each), and
// P goes from the S accumulator to the A operand without shared memory,
// as (c0, c2, c1, c3), V's B fragment reading key rows 2q and 2q + 1.
// Row strides (q and K: dqk + 8 or + 16, 8 mod 16 words; V: dv + 4) keep
// every fragment read on 32 distinct banks and each row 16-byte aligned.
// S = Q K^T keeps its cross terms in an accumulator of their own, added
// once a tile. A tile's P V (cross terms first) goes into a sum of its
// own, added to the running output sum by one rounded multiply-add with
// the rescale: the tensor core truncates what it adds, and a running sum
// fed by every tile would gather that error over long rows. Exponentials
// are exp2 with log2(e) folded into the scale. A warp skips a tile where
// its rows all lie past sq or every key lies above the diagonal for all
// of them.
//
// The forms measured (PERF.md): what sets the time is how many
// warps an SM holds to hide the latencies of the fragment reads, splits
// and mma.sync chains. This form, q fragments read from shared memory and
// split at each tile, with 32-key tiles, takes 125 registers at dv 64 and
// 53 KB of shared memory: four blocks (16 warps) an SM. q split once into
// registers, and 64-key tiles, each cost registers that leave two blocks
// an SM: 6% faster at a causal 512-row prefill (one wave of blocks),
// 24-27% slower at whisper-small's encoder shape (three waves), which the
// serving path launches 72 times as often. K and V split once a tile into (hi,
// lo) tiles in shared memory (128-bit fragment reads, no splits in the
// product loops, but a second barrier a tile and the shared memory of the
// split tiles) measured slower at both. Eight-warp blocks, the float
// itself as the split's high part, and V's low part rounded before the
// tensor core reads it measured no better: the largest error at those
// shapes comes from the low parts' truncation in every product. The key
// tile is 32 at every dim (ptxas: no spills, 244 registers at dv 256); 6
// kernels, one per storage dim of dv.
// mma.sync, not wgmma: a TF32 wgmma needs both operands K-major in shared
// memory; V arrives [keys, dv], so P V's B operand is MN-major and would
// need a transposed copy of every tile, and 3xTF32 hi and lo copies of it
// (csrc/rwkv6.cu records that such a build measured no faster there). Shared
// memory at dqk = dv = 64: 18 KB of q and 2 x 2 x 9 KB of K/V stages; at 256
// / 256: 66 KB and 2 x 2 x 33 KB.
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
// = 80) are what separate it from the bound. The float32 kernel at
// whisper-small's encoder shape (b 4, s 1,500, h 12, d 64, not causal)
// has 27.6 GFLOP of products: 0.056 ms at the 495 TFLOP/s TF32 peak with
// the split counted once, 0.168 ms for its three products (the design's
// floor), against 0.022 ms for its 74 MB of q, k, v and out; so it too is
// bound by operations. mma.sync issues at most one m16n8k8 an SM a clock
// (the TF32 peak) and reaches only part of that on Hopper; the splits,
// the softmax and the fragment reads between the products share the
// warps' issue slots with it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <initializer_list>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "smem_opt_in.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kErrHeadDim = 1000;
constexpr int kErrLibcuda = 1001;
constexpr int kErrTensorMap = 1002;
constexpr int kErrAlign = 1003;

// the head-dim rule: a multiple of 8 from 8 (up to kMaxHeadDim the
// bf16 and float32 kernels, past it flash_wide_kernel)
__host__ __device__ constexpr bool head_dim_ok(int d) {
  return d >= 8 && d % 8 == 0;
}
// the storage dim a head dim pads to: 16, 32 or 64 up to 64, else the
// next multiple of 64
__host__ __device__ constexpr int storage_dim(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : (d + 63) / 64 * 64;
}

constexpr float kNegInf = -1e30f;

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

// ---------------------------------------------------------------------
// float32: 3xTF32 mma.sync, K/V tiles by cp.async.

constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Rows = 16 * kF32Warps;   // q tile: 16 rows a warp
constexpr int kF32Stages = 2;              // K/V tiles in flight
constexpr int kF32Keys = 32;               // keys a K/V tile holds
// row strides in floats: q and K dq + 8 or + 16 (8 mod 16), so the
// 8-byte reads of dims 2q and 2q + 1 for rows g hit distinct banks; V
// dv + 4, so the reads of key rows 2q and 2q + 1 at column g do
__host__ __device__ constexpr int qk_ld(int dq) {
  return dq + (dq % 16 ? 16 : 8);
}
// the q tile and a ring of kF32Stages K/V tiles; the most is at dq 256
// (an instantiation's opt-in)
constexpr size_t f32_smem_bytes(int dq, int dv) {
  return sizeof(float) * ((size_t)kF32Rows * qk_ld(dq) +
                          (size_t)kF32Stages * kF32Keys *
                              (qk_ld(dq) + dv + 4));
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

// A thread's share of a tile of rows of d floats (d a multiple of 8), in
// 16-byte pieces: pieces tid, tid + kF32Threads, ... of the row-major
// order, walked by carries rather than a division per piece.
struct TileCopy {
  int r0, c0, rstep, cstep, chunks;
  __device__ explicit TileCopy(int d)
      : r0(threadIdx.x / (d / 4)), c0(threadIdx.x % (d / 4)),
        rstep(kF32Threads / (d / 4)), cstep(kF32Threads % (d / 4)),
        chunks(d / 4) {}
  // f(row, column) of each of this thread's pieces of a `rows`-row tile
  template <class F>
  __device__ __forceinline__ void each(int rows, F f) const {
    int r = r0, c = c0;
    while (r < rows) {
      f(r, 4 * c);
      r += rstep;
      c += cstep;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  }
  // rows [0, rows) of src (row stride `stride` floats) into dst (row
  // stride ld); rows from `valid` on are zero-filled and read nothing, so
  // no copy crosses into the next batch row
  __device__ __forceinline__ void copy(float* dst, int ld, const float* src,
                                       size_t stride, int rows,
                                       int valid) const {
    each(rows, [&](int r, int c) {
      const bool in = r < valid;
      cp_async16(dst + r * ld + c, src + (in ? r * stride : 0) + c,
                 in ? 16 : 0);
    });
  }
};

// DV: dv's storage dim (the output sum's 8-column groups). dq and dv are
// the real dims, multiples of 8.
template <int DV>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int h, int kh, int dq, int dv, float scale_log2,
                 int causal) {
  constexpr int KEYS = kF32Keys;
  constexpr int NK = KEYS / 8;             // 8-key groups of a tile
  constexpr int NV = DV / 8;               // 8-column groups of the output
  constexpr int YC = NV < 8 ? NV : 8;      // output groups a P V pass
  extern __shared__ __align__(16) float smem_f32[];
  const int ldk = qk_ld(dq), ldv = dv + 4;
  float* ks = smem_f32;                          // [stage][KEYS][ldk]
  float* vs = ks + kF32Stages * KEYS * ldk;      // [stage][KEYS][ldv]
  float* qs = vs + kF32Stages * KEYS * ldv;      // [kF32Rows][ldk]

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int qtile = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                           : (int)blockIdx.y;
  const int q0 = qtile * kF32Rows;
  // kv tiles to walk: all, or (causal) those with a key <= the tile's
  // last query row
  int n_kv = (sk + KEYS - 1) / KEYS;
  if (causal) {
    const int last = min(min(q0 + kF32Rows, sq), sk) - 1;
    n_kv = min(n_kv, last / KEYS + 1);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int qw = q0 + 16 * warp;               // the warp's first row

  // q once (its own group), then the first K/V tile
  const TileCopy tile_k(dq), tile_v(dv);
  const size_t k_stride = (size_t)kh * dq, v_stride = (size_t)kh * dv;
  const float* k_head = k + ((size_t)batch * sk * kh + kv_head) * dq;
  const float* v_head = v + ((size_t)batch * sk * kh + kv_head) * dv;
  auto load_kv = [&](int j) {
    const int st = j % kF32Stages, k0 = j * KEYS;
    tile_k.copy(ks + st * KEYS * ldk, ldk, k_head + k0 * k_stride, k_stride,
                KEYS, sk - k0);
    tile_v.copy(vs + st * KEYS * ldv, ldv, v_head + k0 * v_stride, v_stride,
                KEYS, sk - k0);
    cp_async_commit();
  };
  tile_k.copy(qs, ldk, q + (((size_t)batch * sq + q0) * h + head) * dq,
              (size_t)h * dq, kF32Rows, sq - q0);
  cp_async_commit();
  load_kv(0);

  // The products run over each group of 8 dims (or keys) in a permuted
  // order: A's column q is element 2q of the group and its column q + 4
  // element 2q + 1 (the group's sum is the same). For S that makes a
  // lane's two q elements, and its two K elements, adjacent in a row;
  // for P V it makes P's A fragment the S accumulator's (c0, c2, c1, c3).
  // The warp's A fragment of q for dims 8 kk .. 8 kk + 7, split:
  auto q_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const float* p = qs + (16 * warp + g) * ldk + 8 * kk + 2 * qd;
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * ldk);
    split_tf32(r0.x, ah[0], al[0]);
    split_tf32(r1.x, ah[1], al[1]);
    split_tf32(r0.y, ah[2], al[2]);
    split_tf32(r1.y, ah[3], al[3]);
  };
  cp_async_wait<1>();                          // q has arrived
  __syncthreads();

  float acc[NV][4];
#pragma unroll
  for (int y = 0; y < NV; ++y)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[y][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    // tile j has arrived, and every warp is done with tile j - 1, whose
    // buffers the next copy refills
    cp_async_wait<0>();
    __syncthreads();
    const int st = j % kF32Stages, k0 = j * KEYS;
    const float* kt = ks + st * KEYS * ldk;
    const float* vt = vs + st * KEYS * ldv;
    if (j + 1 < n_kv) load_kv(j + 1);
    else cp_async_commit();
    // nothing to add: the warp's rows all lie past sq (the last q tile),
    // or every key of the tile lies above the diagonal for all of them
    // (p = 0, the running max unchanged)
    if (qw >= sq || (causal && k0 > qw + 15)) continue;

    // S = Q K^T in 3xTF32: hi hi in s, the cross terms in cr
    float s[NK][4], cr[NK][4];
#pragma unroll
    for (int x = 0; x < NK; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[x][e] = cr[x][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < dq / 8; ++kk) {
      uint32_t ah[4], al[4];
      q_frag(kk, ah, al);
#pragma unroll
      for (int x = 0; x < NK; ++x) {
        // K's (hi, lo) at key 8 x + g, dims 8 kk + 2q and 8 kk + 2q + 1
        const float2 f = *reinterpret_cast<const float2*>(
            kt + (8 * x + g) * ldk + 8 * kk + 2 * qd);
        uint32_t bh[2], bl[2];
        split_tf32(f.x, bh[0], bl[0]);
        split_tf32(f.y, bh[1], bl[1]);
        mma_tf32(cr[x], al, bh);
        mma_tf32(cr[x], ah, bl);
        mma_tf32(s[x], ah, bh);
      }
    }

    // masked scores become -1e30, keys past sk -inf, both before the
    // scaling (scale > 0 keeps the order); lane (g, q) holds rows g and
    // g + 8, keys 8 x + 2q and 8 x + 2q + 1
    const bool edge = (causal && k0 + KEYS - 1 > qw) || k0 + KEYS > sk;
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
        // p = 2^(s scale log2(e) - m): one multiply-add and one exp2
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

    // O = O corr + P V: the tile's P V in 3xTF32 (the cross terms first)
    // into a sum of its own, YC output groups a pass, then one rounded
    // multiply-add into the running sum (the tensor core truncates what
    // it adds, and the running sum would gather that over every tile).
    // P's A fragment is the S accumulator's (c0, c2, c1, c3).
#pragma unroll
    for (int y0 = 0; y0 < NV; y0 += YC) {
      if (8 * y0 >= dv) break;
      float t[YC][4];
#pragma unroll
      for (int yy = 0; yy < YC; ++yy)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[yy][e] = 0.f;
#pragma unroll
      for (int x = 0; x < NK; ++x) {
        uint32_t ah[4], al[4];
        split_tf32(s[x][0], ah[0], al[0]);
        split_tf32(s[x][2], ah[1], al[1]);
        split_tf32(s[x][1], ah[2], al[2]);
        split_tf32(s[x][3], ah[3], al[3]);
#pragma unroll
        for (int yy = 0; yy < YC; ++yy) {
          if (8 * (y0 + yy) >= dv) break;
          // V's (hi, lo) at keys 8 x + 2q and 8 x + 2q + 1, column
          // 8 (y0 + yy) + g
          const float* p = vt + (8 * x + 2 * qd) * ldv + 8 * (y0 + yy) + g;
          uint32_t bh[2], bl[2];
          split_tf32(p[0], bh[0], bl[0]);
          split_tf32(p[ldv], bh[1], bl[1]);
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
  cp_async_wait<0>();            // no copy outlives the block

  // the real dv columns only (whole 8-column groups)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    if (qpos >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    float* dst = o + (((size_t)batch * sq + qpos) * h + head) * dv + 2 * qd;
#pragma unroll
    for (int y = 0; y < NV; ++y)
      if (8 * y < dv)
        *reinterpret_cast<float2*>(dst + 8 * y) =
            make_float2(acc[y][2 * r] * inv_l, acc[y][2 * r + 1] * inv_l);
  }
}

// ---------------------------------------------------------------------
// Head dims past 256 (either of dqk and dv, each a multiple of 8): bf16
// flash_wide_wgmma_kernel<DVH> (wgmma + TMA) and float32
// flash_wide_f32_kernel<NVH> (3xTF32 mma.sync).
//
// The kernels above hold a 64- or 128-row output sum of the whole dv in
// registers and a q tile whole, which caps them at 256 (ROADMAP C17). At
// DeepSeek-V2-Lite's absorbed MLA (dqk 576, dv 512) a 64-row tile's output
// sum is 64 x 512 floats, more than one warpgroup's registers hold. So a
// block here owns (batch x head, 64-row q tile) and up to 512 columns of
// v, split between two halves of its warps that share one S: each half
// computes S = Q K^T for all of a 32-key tile's keys over half of q/K's
// columns, the two swap their partial S through shared memory (a thread
// of one half holds the same scores as its counterpart of the other) and
// add them in one order, half 0's first, so both hold the same S, max, P
// and denominator; each then multiplies P by the V columns it holds. No
// block recomputes S for v's columns up to 512; past 512 (no config has
// such a head) v's columns are cut across blocks in slices of 512
// (gridDim.z), each recomputing S with the same arithmetic, so slices
// agree. Rows past sq or sk and columns past the real dims load as zeros
// and add exact zeros; the causal grid starts with the q tiles that have
// the most key tiles.
//
// bf16, flash_wide_wgmma_kernel<DVH>: three warpgroups, as
// flash_wgmma_kernel: a producer whose elected thread loads by TMA (the
// 128-byte swizzled 64-column spans wgmma reads) and two consumers of the
// same 64 q rows, warpgroup w holding v columns [w DVH, (w + 1) DVH) of
// the block's (DVH 64, 128, 192 or 256: at dv 512 128 accumulator
// registers a thread; setmaxnreg gives a consumer 232). q is loaded once
// and held whole where it fits (64 x 576 bf16 is 72 KB); K tiles of 32
// keys come through a ring of two stages, a stage holding `sps` of the
// tile's 64-column spans (all 9 at dqk 576), and V tiles through a ring
// of their own. Consumer w runs 16-column steps w and w + 2 of every span
// as wgmma m64n32k16 (both operands from shared memory), so each q byte is
// read by one warpgroup; after the swap of S (two named barriers a tile)
// P = exp2(S - m) is rounded to bf16 (ROADMAP C8) in registers, where
// the accumulator's layout is the A operand's, and O += P V runs as two
// wgmma m64n{DVH}k16 with A from registers and the warpgroup's V columns
// from shared memory (MN-major). Shared memory at (576, 512): q 72 KB, two
// K stages 72 KB, two V stages 64 KB, the swap 16 KB: 225 KB, one block
// (12 warps) an SM. Past 576 at dv 512 a K stage holds fewer spans (the
// tile in several stages); q is held whole up to dqk 1,088 at dv 512 and
// 1,472 at dv 128, and past that streams through the ring beside K, a
// span of q for each span of K, read again for every key tile
// (wide_plan).
//
// float32, flash_wide_f32_kernel<NVH>: eight warps, two for each 16-row
// band of the q tile, in 3xTF32 mma.sync.m16n8k8 (csrc/tf32_mma.cuh): the
// band's half 0 multiplies the even groups of 8 q/K columns, half 1 the
// odd ones, each for all 32 keys of the tile in the permuted order of
// flash_f32_kernel, and each holds 8 NVH output columns (NVH 4, 8, 16 or
// 32 groups of 8; at dv 512 128 registers). q and K come in chunks of 128
// columns through a two-stage cp.async ring, a tile's first chunk while
// the tile before it multiplies P by V, its V tile behind that chunk. P
// goes from the S accumulator to the A operand in registers, as in
// flash_f32_kernel; S keeps its cross terms in an accumulator of their
// own, added once a tile, and a tile's P V goes into a sum of its own,
// added to the output sum by one rounded multiply-add with the rescale
// (C27). The splits stay in the product loops: forms whose loading
// threads split q, K, V and P, or V alone, once a tile into shared memory
// (a fragment one 16-byte read, no split) doubled the bytes those reads
// move or ran out of registers, and measured slower (PERF.md). Shared
// memory at NVH 32: 183 KB; one block (8 warps, 237 registers) an SM.
//
// What bounds them: at DeepSeek-V2-Lite's absorbed prefill (b 4, sq = sk
// 2,048, 16 query heads over one latent head, causal) the products are
// 2.9e11 flop, 0.30 ms at the bf16 tensor-core peak and 0.59 ms at the
// TF32 peak with the split counted once (1.77 ms for float32's three
// products), against 0.09 ms (bf16) for the bytes: operations. With 64 q
// rows a block, each 32-key tile's K and V (70 KB in bf16) come from L2
// for 4.5 MFLOP, 64 flop a byte; the swaps of S hold the two warpgroups
// in step, so the tensor cores wait through each tile's softmax. In
// float32 q (147 KB a tile) comes again from L2 for every key tile, and
// P V's fragment reads and splits, not its products, take most of its
// part. PERF.md keeps the times, beside the first form's
// (tools/flash_wide_first.cu).

constexpr int kWideRows = 64;                 // q tile rows
constexpr int kWideKeys = 32;                 // keys a K/V tile holds
constexpr int kWideMaxDv = 512;               // v columns a block holds
constexpr int kWideSpan = 64;                 // columns of a span / piece
constexpr int kSpanK = kWideKeys * 128;       // bytes of a bf16 K or V span
constexpr int kSpanQ = kWideRows * 128;       // bytes of a bf16 q span
constexpr size_t kSmemOptIn = 232448;         // a block's most (227 KB)

// the bf16 kernel's shared memory: q (whole) or none, two ring stages of
// `sps` spans (K, and q when it streams), two V stages of 2 DVH columns,
// the swaps, the barriers and slack to align the base to 1 KB
struct WidePlan {
  int ncb, sps, qwhole;
  size_t bytes;
};
inline size_t wide_bytes(int ncb, int sps, int qwhole, int dvh) {
  return (size_t)(qwhole ? ncb * kSpanQ : 0) +
         (size_t)2 * sps * (kSpanK + (qwhole ? 0 : kSpanQ)) +
         (size_t)2 * (2 * dvh / 64) * kSpanK + 2 * 4 * 128 * 16 + 128 +
         1024;
}
inline WidePlan wide_plan(int dq, int dvh) {
  const int ncb = (dq + kWideSpan - 1) / kWideSpan;
  for (int qwhole = 1; qwhole >= 0; --qwhole)
    for (int sps = ncb; sps >= 1; --sps) {
      const size_t bytes = wide_bytes(ncb, sps, qwhole, dvh);
      if (bytes <= kSmemOptIn) return {ncb, sps, qwhole, bytes};
    }
  return {ncb, 0, 0, 0};
}

__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// a barrier of `threads` threads (whole warps) on hardware barrier `id`
// (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// DVH: the v columns a consumer warpgroup holds (64, 128, 192, 256);
// ncb: 64-column spans of q and K; sps: spans a ring stage holds; qwhole:
// q held whole (else it streams beside K). blockIdx.z is the v slice.
template <int DVH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o, int sq, int sk,
                        int h, int kh, int dv, float scale_log2, int causal,
                        int ncb, int sps, int qwhole) {
  constexpr int NCBV = 2 * DVH / 64;         // V spans of a stage
  constexpr int VT = NCBV * kSpanK;          // bytes of a V stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int unit = sps * (kSpanK + (qwhole ? 0 : kSpanQ));
  uint8_t* qs = smem;                        // [ncb][64][64] when whole
  uint8_t* ring = qs + (qwhole ? ncb * kSpanQ : 0);  // [2][sps K, sps q]
  uint8_t* vs = ring + 2 * unit;             // [2][NCBV][32][64]
  float4* xs = reinterpret_cast<float4*>(vs + 2 * VT);   // [2][4][128]
  uint64_t* kfull = reinterpret_cast<uint64_t*>(xs + 2 * 4 * 128);
  uint64_t* kempty = kfull + 2;
  uint64_t* vfull = kfull + 4;
  uint64_t* vempty = kfull + 6;
  uint64_t* qbar = kfull + 8;

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int qtile = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                           : (int)blockIdx.y;
  const int q0 = qtile * kWideRows;
  const int v0 = blockIdx.z * kWideMaxDv;
  int n_kv = (sk + kWideKeys - 1) / kWideKeys;
  if (causal) {
    const int last = min(min(q0 + kWideRows, sq), sk) - 1;
    n_kv = min(n_kv, last / kWideKeys + 1);
  }
  const int units = (ncb + sps - 1) / sps;   // ring stages a key tile
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < 2; ++st) {
      mbar_init(&kfull[st], 1);
      mbar_init(&kempty[st], kConsumers / 32);
      mbar_init(&vfull[st], 1);
      mbar_init(&vempty[st], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                   // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (tid == kConsumers) {
      if (qwhole) {
        mbar_expect_tx(qbar, ncb * kSpanQ);
        for (int cb = 0; cb < ncb; ++cb)
          tma_load(qs + cb * kSpanQ, &tq, qbar, cb * kWideSpan, head, q0,
                   batch);
      }
      int nvs = 0;                           // V spans with real columns
      for (int cb = 0; cb < NCBV; ++cb) nvs += v0 + cb * kWideSpan < dv;
      int u = 0;
      for (int j = 0; j < n_kv; ++j) {
        const int k0 = j * kWideKeys, vst = j & 1;
        if (j >= 2) mbar_wait(&vempty[vst], ((j >> 1) - 1) & 1);
        mbar_expect_tx(&vfull[vst], nvs * kSpanK);
        for (int cb = 0; cb < nvs; ++cb)
          tma_load(vs + vst * VT + cb * kSpanK, &tv, &vfull[vst],
                   v0 + cb * kWideSpan, kv_head, k0, batch);
        for (int un = 0; un < units; ++un, ++u) {
          const int st = u & 1, c0 = un * sps;
          const int n = min(sps, ncb - c0);
          if (u >= 2) mbar_wait(&kempty[st], ((u >> 1) - 1) & 1);
          uint8_t* slot = ring + st * unit;
          mbar_expect_tx(&kfull[st],
                         n * (kSpanK + (qwhole ? 0 : kSpanQ)));
          for (int i = 0; i < n; ++i) {
            tma_load(slot + i * kSpanK, &tk, &kfull[st],
                     (c0 + i) * kWideSpan, kv_head, k0, batch);
            if (!qwhole)
              tma_load(slot + sps * kSpanK + i * kSpanQ, &tq, &kfull[st],
                       (c0 + i) * kWideSpan, head, q0, batch);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: all 64 rows of the tile; this thread's rows r0
  // and r0 + 8, S columns (keys) 8 i + 2 (lane % 4) + e, output columns
  // v0 + wg DVH + 8 i + 2 (lane % 4) + e
  regs_inc<kConsumerRegs>();
  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const int cpos = 2 * (lane % 4);
  const bool has_cols = v0 + wg * DVH < dv;
  float acc[DVH / 2];
#pragma unroll
  for (int i = 0; i < DVH / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  if (qwhole) mbar_wait(qbar, 0);

  int u = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kWideKeys;
    // this warpgroup's part of S = Q K^T for the tile's 32 keys: 16-column
    // steps wg and wg + 2 of every span
    float s[16];
    for (int un = 0; un < units; ++un, ++u) {
      const int st = u & 1, c0 = un * sps;
      const int n = min(sps, ncb - c0);
      mbar_wait(&kfull[st], (u >> 1) & 1);
      const uint32_t kb = smem_u32(ring + st * unit);
      const uint32_t qb = qwhole ? smem_u32(qs) + c0 * kSpanQ
                                 : smem_u32(ring + st * unit) + sps * kSpanK;
      wgmma_fence();
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int off = (2 * kh + wg) * 32;
          wgmma_ss_n32(s, smem_desc(qb + i * kSpanQ + off, 16, 1024, 1),
                       smem_desc(kb + i * kSpanK + off, 16, 1024, 1),
                       un > 0 || i > 0 || kh > 0);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<16>(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kempty[st]);
    }
    // S: warpgroup 0's part plus warpgroup 1's, swapped through shared
    // memory (thread t of each holds the same rows and keys), so both hold
    // the same scores, max, P and denominator
#pragma unroll
    for (int x = 0; x < 4; ++x)
      xs[(wg * 4 + x) * 128 + t] =
          make_float4(s[4 * x], s[4 * x + 1], s[4 * x + 2], s[4 * x + 3]);
    bar_sync(1, kConsumers);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 ot = xs[((1 - wg) * 4 + x) * 128 + t];
      const float other[4] = {ot.x, ot.y, ot.z, ot.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * x + e] = wg == 0 ? s[4 * x + e] + other[e]
                               : other[e] + s[4 * x + e];
    }
    bar_sync(1, kConsumers);                 // both read before the next

    // masked scores -1e30, keys past sk -inf, before the scaling
    const bool edge = (causal && k0 + kWideKeys - 1 > q0) ||
                      k0 + kWideKeys > sk;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
    // P rounded to bf16 in the A layout of the tile's two 16-key steps
    uint32_t pa[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p0 = fexp2(fmaf(s[4 * i], scale_log2, -m[0]));
      const float p1 = fexp2(fmaf(s[4 * i + 1], scale_log2, -m[0]));
      const float p2 = fexp2(fmaf(s[4 * i + 2], scale_log2, -m[1]));
      const float p3 = fexp2(fmaf(s[4 * i + 3], scale_log2, -m[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
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
    for (int i = 0; i < DVH / 8; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }
    const int vst = j & 1;
    mbar_wait(&vfull[vst], (j >> 1) & 1);
    if (has_cols) {
      const uint32_t vb = smem_u32(vs + vst * VT) + wg * (DVH / 64) * kSpanK;
      wgmma_fence();
      wgmma_pv<DVH>(acc, pa[0], smem_desc(vb, kSpanK, 1024, 1));
      wgmma_pv<DVH>(acc, pa[1], smem_desc(vb + 16 * 128, kSpanK, 1024, 1));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DVH / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&vempty[vst]);
  }

  if (!has_cols) return;
  // the real dv columns only (whole 8-column groups)
  const int c0 = v0 + wg * DVH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        o + (((size_t)batch * sq + qpos[r]) * h + head) * dv + c0 + cpos;
#pragma unroll
    for (int i = 0; i < DVH / 8; ++i)
      if (c0 + 8 * i < dv)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv_l,
                                  acc[4 * i + 2 * r + 1] * inv_l);
  }
}

// float32: q and K chunks of 128 columns (rows kF32WideLd floats apart, 8
// mod 16: a lane's float2 reads of dims 2q and 2q + 1 for rows g fall on
// distinct banks) through a ring of two stages, the block's V tile (rows
// 16 NVH + 4 floats apart, 4 mod 32), and the swap of the partial S
constexpr int kF32WideThreads = 256;          // eight warps
constexpr int kF32WideChunk = 128;            // q/K columns a chunk holds
constexpr int kF32WideLd = kF32WideChunk + 8;
template <int NVH>
__host__ __device__ constexpr int f32_wide_ldv() {
  return 16 * NVH + 4;
}
template <int NVH>
constexpr size_t f32_wide_smem() {
  return sizeof(float) *
         ((size_t)2 * (kWideRows + kWideKeys) * kF32WideLd +
          (size_t)kWideKeys * f32_wide_ldv<NVH>() + 8 * 4 * 32 * 4);
}

// rows [0, rows) x columns [0, cols) of a row-major source (row stride
// `stride` floats) into shared memory (row stride ld), in 16-byte pieces
// shared by the block's threads; rows from `valid` on are zero-filled
// and read nothing (cols a multiple of 4)
__device__ __forceinline__ void f32_tile_copy(float* dst, int ld,
                                              const float* src,
                                              size_t stride, int rows,
                                              int cols, int valid) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += kF32WideThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    const bool in = r < valid;
    cp_async16(dst + r * ld + c, src + (in ? r * stride + c : 0),
               in ? 16 : 0);
  }
}

// NVH: 8-column groups of the output a warp holds (4, 8, 16, 32); the
// block's v columns (up to 512) are split between the two warps of a
// band, half 0 taking the first vh0. dq and dv are the real dims,
// multiples of 8; blockIdx.z is the v slice.
template <int NVH>
__global__ void __launch_bounds__(kF32WideThreads, 1)
flash_wide_f32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int sq, int sk, int h, int kh, int dq, int dv,
                      float scale_log2, int causal) {
  constexpr int LD = kF32WideLd;
  constexpr int LDV = f32_wide_ldv<NVH>();
  constexpr int NK = kWideKeys / 8;          // 8-key groups of a tile
  constexpr int YC = NVH < 8 ? NVH : 8;      // output groups a P V pass
  extern __shared__ __align__(16) float smem_f32w[];
  float* qs = smem_f32w;                             // [2][64][LD]
  float* ks = qs + 2 * kWideRows * LD;               // [2][32][LD]
  float* vs = ks + 2 * kWideKeys * LD;               // [32][LDV]
  float4* xs = reinterpret_cast<float4*>(vs + kWideKeys * LDV);  // [8][4][32]

  const int bh = blockIdx.x;
  const int batch = bh / h, head = bh % h;
  const int kv_head = head / (h / kh);
  const int qtile = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                           : (int)blockIdx.y;
  const int q0 = qtile * kWideRows;
  const int v0 = blockIdx.z * kWideMaxDv;
  const int vb = min(kWideMaxDv, dv - v0);   // the block's v columns
  const int vh0 = (vb / 8 + 1) / 2 * 8;      // half 0's; half 1 the rest
  int n_kv = (sk + kWideKeys - 1) / kWideKeys;
  if (causal) {
    const int last = min(min(q0 + kWideRows, sq), sk) - 1;
    n_kv = min(n_kv, last / kWideKeys + 1);
  }
  const int n_chunks = (dq + kF32WideChunk - 1) / kF32WideChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;
  const int band = warp & 3, hf = warp >> 2;
  const int qw = q0 + 16 * band;                // the band's first row
  const int vcols = hf ? vb - vh0 : vh0;        // this warp's v columns
  const int vc = hf ? vh0 : 0;                  // ... from this one on

  const size_t q_stride = (size_t)h * dq, k_stride = (size_t)kh * dq;
  const size_t v_stride = (size_t)kh * dv;
  const float* q_tile = q + (((size_t)batch * sq + q0) * h + head) * dq;
  const float* k_head = k + ((size_t)batch * sk * kh + kv_head) * dq;
  const float* v_head = v + ((size_t)batch * sk * kh + kv_head) * dv + v0;
  // the q and K columns of chunk c into stage c % 2
  auto load_chunk = [&](int c, int k0) {
    const int c0 = c * kF32WideChunk, st = c % 2;
    const int cols = min(kF32WideChunk, dq - c0);
    f32_tile_copy(qs + st * kWideRows * LD, LD, q_tile + c0, q_stride,
                  kWideRows, cols, sq - q0);
    f32_tile_copy(ks + st * kWideKeys * LD, LD, k_head + k0 * k_stride + c0,
                  k_stride, kWideKeys, cols, sk - k0);
    cp_async_commit();
  };

  float acc[NVH][4];
#pragma unroll
  for (int y = 0; y < NVH; ++y)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[y][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  // chunk 0 of a tile is copied before the tile before it multiplies P
  // by V, the tile's V after that chunk, and the next chunk while a chunk's
  // products run (cp.async groups complete in order)
  load_chunk(0, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kWideKeys;
    f32_tile_copy(vs, LDV, v_head + k0 * v_stride, v_stride, kWideKeys, vb,
                  sk - k0);
    cp_async_commit();
    // a band whose rows all lie past sq, or above the diagonal for every
    // key of the tile, adds nothing (p = 0, the running max unchanged)
    const bool active = qw < sq && !(causal && k0 > qw + 15);
    // this warp's part of S = Q K^T in 3xTF32 (hi hi in s, the cross
    // terms in cr): the even (half 0) or odd groups of 8 columns, each in
    // the permuted order of flash_f32_kernel (A's column q is element 2q
    // of the group, its column q + 4 element 2q + 1; K's likewise)
    float s[NK][4], cr[NK][4];
#pragma unroll
    for (int x = 0; x < NK; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[x][e] = cr[x][e] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      // chunk c has arrived (and V, from chunk 1 on)
      if (c + 1 < n_chunks) {
        load_chunk(c + 1, k0);
        if (c == 0) cp_async_wait<2>();
        else cp_async_wait<1>();
      } else if (c == 0) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int st = c % 2;
      const int kend = min(kF32WideChunk, dq - c * kF32WideChunk);
      if (active) {
        const float* qa = qs + (st * kWideRows + 16 * band + g) * LD + 2 * qd;
        const float* kb = ks + (st * kWideKeys + g) * LD + 2 * qd;
#pragma unroll
        for (int t = 0; t < kF32WideChunk / 16; ++t) {
          const int kk = 16 * t + 8 * hf;
          if (kk >= kend) break;
          const float2 r0 = *reinterpret_cast<const float2*>(qa + kk);
          const float2 r1 =
              *reinterpret_cast<const float2*>(qa + 8 * LD + kk);
          uint32_t ah[4], al[4];
          split_tf32(r0.x, ah[0], al[0]);
          split_tf32(r1.x, ah[1], al[1]);
          split_tf32(r0.y, ah[2], al[2]);
          split_tf32(r1.y, ah[3], al[3]);
#pragma unroll
          for (int x = 0; x < NK; ++x) {
            const float2 f =
                *reinterpret_cast<const float2*>(kb + 8 * x * LD + kk);
            uint32_t bh[2], bl[2];
            split_tf32(f.x, bh[0], bl[0]);
            split_tf32(f.y, bh[1], bl[1]);
            mma_tf32(cr[x], al, bh);
            mma_tf32(cr[x], ah, bl);
            mma_tf32(s[x], ah, bh);
          }
        }
      }
      __syncthreads();                       // before stage st refills
    }
    if (n_chunks == 1) {                     // V has not been waited for
      cp_async_wait<0>();
      __syncthreads();
    }
    if (j + 1 < n_kv) load_chunk(0, k0 + kWideKeys);
    if (active) {
      // S: half 0's part plus half 1's, swapped between the band's two
      // warps (lane (g, q) of each holds the same rows g and g + 8, keys
      // 8 x + 2q and 8 x + 2q + 1), so both hold the same scores
#pragma unroll
      for (int x = 0; x < NK; ++x)
        xs[(warp * NK + x) * 32 + lane] =
            make_float4(s[x][0] + cr[x][0], s[x][1] + cr[x][1],
                        s[x][2] + cr[x][2], s[x][3] + cr[x][3]);
      bar_sync(1 + band, 64);
      const bool edge =
          (causal && k0 + kWideKeys - 1 > qw) || k0 + kWideKeys > sk;
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int x = 0; x < NK; ++x) {
        const float4 ot = xs[((warp ^ 4) * NK + x) * 32 + lane];
        const float other[4] = {ot.x, ot.y, ot.z, ot.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float own = s[x][e] + cr[x][e];
          float sc = hf == 0 ? own + other[e] : other[e] + own;
          if (edge) {
            // masked scores -1e30, keys past sk -inf, before the scaling
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
      // O = O corr + P V over this warp's columns: the tile's P V in
      // 3xTF32 (cross terms first) into a sum of its own, YC output
      // groups a pass, then one rounded multiply-add with the rescale;
      // P's A fragment is the S accumulator's (c0, c2, c1, c3), V's B
      // fragment key rows 8 x + 2q and 8 x + 2q + 1 at column 8 y + g
#pragma unroll
      for (int y0 = 0; y0 < NVH; y0 += YC) {
        if (8 * y0 >= vcols) break;
        float t[YC][4];
#pragma unroll
        for (int yy = 0; yy < YC; ++yy)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[yy][e] = 0.f;
#pragma unroll
        for (int x = 0; x < NK; ++x) {
          uint32_t ah[4], al[4];
          split_tf32(s[x][0], ah[0], al[0]);
          split_tf32(s[x][2], ah[1], al[1]);
          split_tf32(s[x][1], ah[2], al[2]);
          split_tf32(s[x][3], ah[3], al[3]);
#pragma unroll
          for (int yy = 0; yy < YC; ++yy) {
            if (8 * (y0 + yy) >= vcols) break;
            const float* vb_ =
                vs + (8 * x + 2 * qd) * LDV + vc + 8 * (y0 + yy) + g;
            uint32_t bh[2], bl[2];
            split_tf32(vb_[0], bh[0], bl[0]);
            split_tf32(vb_[LDV], bh[1], bl[1]);
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
    __syncthreads();                         // before V and stage 0 refill
  }

  // this warp's real columns only (whole 8-column groups)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw + g + 8 * r;
    if (qpos >= sq) continue;
    const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
    float* dst = o + (((size_t)batch * sq + qpos) * h + head) * dv + v0 +
                 vc + 2 * qd;
#pragma unroll
    for (int y = 0; y < NVH; ++y)
      if (8 * y < vcols)
        *reinterpret_cast<float2*>(dst + 8 * y) =
            make_float2(acc[y][2 * r] * inv_l, acc[y][2 * r + 1] * inv_l);
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

// the float32 kernel at dv's storage dim DV
template <int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int h, int kh, int dq, int dv, float scale,
               int causal, cudaStream_t stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kErrAlign;
  const cudaError_t attr = smem_opt_in(
      flash_f32_kernel<DV>, (int)f32_smem_bytes(kMaxHeadDim, DV));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b * h, (sq + kF32Rows - 1) / kF32Rows);
  flash_f32_kernel<DV><<<grid, kF32Threads, f32_smem_bytes(dq, dv), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, kh,
      dq, dv, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// the v columns a warpgroup of the bf16 wide kernel holds: half of the
// block's (up to 512), rounded up to whole 64-column spans
int wide_dvh(int dv) {
  const int half = (min(dv, kWideMaxDv) + 1) / 2;
  return half <= 64 ? 64 : half <= 128 ? 128 : half <= 192 ? 192 : 256;
}
// the output groups a warp of the float32 wide kernel holds: half 0's
// columns of the block's
int wide_nvh(int dv) {
  const int groups = (min(dv, kWideMaxDv) / 8 + 1) / 2;
  return groups <= 4 ? 4 : groups <= 8 ? 8 : groups <= 16 ? 16 : 32;
}

template <int DVH>
int launch_wide_wgmma(const void* q, const void* k, const void* v, void* o,
                      int b, int sq, int sk, int h, int kh, int dq, int dv,
                      float scale, int causal, cudaStream_t stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kErrAlign;
  const WidePlan plan = wide_plan(dq, DVH);
  if (!plan.bytes) return kErrHeadDim;
  const cudaError_t attr =
      smem_opt_in(flash_wide_wgmma_kernel<DVH>, (int)kSmemOptIn);
  if (attr != cudaSuccess) return (int)attr;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return kErrLibcuda;
  const int dqs = plan.ncb * kWideSpan;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, b, sq, h, dq, dqs, kWideRows) ||
      !tensor_map(encode, &tk, k, b, sk, kh, dq, dqs, kWideKeys) ||
      !tensor_map(encode, &tv, v, b, sk, kh, dv, 2 * DVH, kWideKeys))
    return kErrTensorMap;
  const dim3 grid(b * h, (sq + kWideRows - 1) / kWideRows,
                  (dv + kWideMaxDv - 1) / kWideMaxDv);
  flash_wide_wgmma_kernel<DVH><<<grid, kWgThreads, plan.bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, h, kh, dv,
      scale * 1.4426950408889634f, causal, plan.ncb, plan.sps, plan.qwhole);
  return (int)cudaGetLastError();
}

template <int NVH>
int launch_wide_f32(const void* q, const void* k, const void* v, void* o,
                    int b, int sq, int sk, int h, int kh, int dq, int dv,
                    float scale, int causal, cudaStream_t stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return kErrAlign;
  constexpr size_t bytes = f32_wide_smem<NVH>();
  const cudaError_t attr =
      smem_opt_in(flash_wide_f32_kernel<NVH>, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(b * h, (sq + kWideRows - 1) / kWideRows,
                  (dv + kWideMaxDv - 1) / kWideMaxDv);
  flash_wide_f32_kernel<NVH><<<grid, kF32WideThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h, kh,
      dq, dv, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// a head dim past 256: the wide kernel of the type
int launch_wide(const void* q, const void* k, const void* v, void* o,
                int dtype, int b, int sq, int sk, int h, int kh, int dq,
                int dv, float scale, int causal, cudaStream_t stream) {
#define WIDE_CASE(N, FN)                                                   \
  case N:                                                                  \
    return FN<N>(q, k, v, o, b, sq, sk, h, kh, dq, dv, scale, causal, stream)
  if (dtype == 1) {
    switch (wide_dvh(dv)) {
      WIDE_CASE(64, launch_wide_wgmma); WIDE_CASE(128, launch_wide_wgmma);
      WIDE_CASE(192, launch_wide_wgmma); WIDE_CASE(256, launch_wide_wgmma);
    }
  } else {
    switch (wide_nvh(dv)) {
      WIDE_CASE(4, launch_wide_f32); WIDE_CASE(8, launch_wide_f32);
      WIDE_CASE(16, launch_wide_f32); WIDE_CASE(32, launch_wide_f32);
    }
  }
#undef WIDE_CASE
  return kErrHeadDim;
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

// dtype 0: float32 (flash_f32_kernel), 1: bfloat16 (flash_wgmma_kernel);
// a head dim past 256, either, runs the wide kernel of the type
// (flash_wide_f32_kernel, flash_wide_wgmma_kernel).
// dq is the q/k head dim, dv the v head dim. Returns a cudaError_t, or
// 1000 for a head dim outside the rule (a multiple of 8 from 8), 1001
// when libcuda has no cuTensorMapEncodeTiled, 1002 when a tensor map is
// refused, 1003 for operands not 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int b, int sq, int sk, int h,
                           int kh, int dq, int dv, float scale, int causal,
                           void* stream) {
  if (!head_dim_ok(dq) || !head_dim_ok(dv)) return kErrHeadDim;
  if (b <= 0 || sq <= 0 || sk <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dq > kMaxHeadDim || dv > kMaxHeadDim)
    return launch_wide(q, k, v, o, dtype, b, sq, sk, h, kh, dq, dv, scale,
                       causal, st);
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
      return "head dims must be multiples of 8 from 8";
    case kErrLibcuda: return "libcuda has no cuTensorMapEncodeTiled";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrAlign: return "operands must be 16-byte aligned";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
