// Float32 products on the TF32 tensor cores: the 3xTF32 split and
// mma.sync.m16n8k8, shared by csrc/rwkv6.cu (the chunked WKV kernel) and
// csrc/flash_attention.cu (the float32 flash kernel).
//
// A float x is split into a TF32 high part and the exact remainder,
// x = hi + lo; a product of two split floats is taken as hi lo + lo hi +
// hi hi, three TF32 products with float32 accumulation, which keeps it
// within ~2^-20 of the float32 product (one TF32 pass, hi hi alone, is
// within 2^-10). mma.sync.m16n8k8 fragments, for lane = 4 g + q of a warp:
// A (16 x 8, row-major) a0 (g, q), a1 (g + 8, q), a2 (g, q + 4),
// a3 (g + 8, q + 4); B (8 x 8) b0 (q, g), b1 (q + 4, g); C and D (16 x 8)
// c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1).

#pragma once

#include <stdint.h>

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
