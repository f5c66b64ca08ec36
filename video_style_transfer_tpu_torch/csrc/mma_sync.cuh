// mma.sync building blocks shared by the port's warp-level tensor-core
// kernels: the 3xTF32 arithmetic of K1's and K4's fp32 route
// (flash_attention_tf32.cu) and of K3's and K5's fp32 kernels, the bf16
// m16n8k16 and m16n8k8 products of K3's and K5's bf16 kernels, ldmatrix
// and movmatrix.
//
// Fragment layouts (g = lane / 4, t = lane % 4): an m16n8 f32 accumulator
// c[0], c[1] holds row g, columns 2t, 2t + 1, c[2], c[3] row g + 8. A bf16
// m16n8k16 A fragment a[0] = (g, 2t..), a[1] = (g + 8, 2t..), a[2] = (g,
// 2t + 8..), a[3] = (g + 8, 2t + 8..), two bf16 a register; its B fragment
// b[0] = (k 2t, 2t + 1; n g), b[1] = (k 2t + 8, 2t + 9; n g). m16n8k8
// bf16 takes a[0], a[1] and b[0] alone.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace vst {

// ----------------------------------------------------------------- 3xTF32

struct FragA {  // m16n8k8 A (16 x 8): rows g, g + 8; k slots t, t + 4
  uint32_t hi[4], lo[4];
};
struct FragB {  // m16n8k8 B (8 x 8): k slots t, t + 4; column g
  uint32_t hi[2], lo[2];
};

// fp32 bits rounded to TF32, to nearest with ties away from zero: the
// magnitude bits plus half of the 13 dropped bits, then those bits
// cleared. This is cvt.rna.tf32.f32 on finite values (and on
// infinities); the instruction itself compiles to a NaN-guarded sequence
// of four or five.
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at 3xTF32: a.lo b.hi, a.hi b.lo, a.hi b.hi. SWAPPED takes the
// two small terms the other way round, so that a product with A and B
// exchanged (S^T = K Q^T against S = Q K^T) adds the same terms in the
// same order.
template <bool SWAPPED>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  if (SWAPPED) {
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.lo, b.hi);
  } else {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
  }
  mma_tf32(c, a.hi, b.hi);
}

// One 8-column n tile of an m16n8 accumulator (c[0], c[1]: row g, columns
// 2t, 2t + 1; c[2], c[3]: row g + 8) as the A fragment of the k step over
// those 8 columns, its k order permuted: slot t takes column 2t, slot
// t + 4 column 2t + 1 (the product's B rows are taken in the same order)
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// A from four values already in registers (a[0] .. a[3]: (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4))
__device__ __forceinline__ void split_a(FragA& f, const float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
}

// ------------------------------------------------------------------ bf16

// c += a b, bf16 m16n8k16 with f32 accumulation
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b, bf16 m16n8k8 (a[0], a[1]; b) with f32 accumulation
__device__ __forceinline__ void mma_1688(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// -------------------------------------------------------------- ldmatrix

// Each lane gives the shared-memory address of one 16-byte row: lanes
// 8i .. 8i + 7 the rows of 8 x 8 matrix i (16-bit elements), which lands
// in r[i] as lane (g, t) = row g, elements 2t, 2t + 1 (.trans: row 2t and
// 2t + 1 of column g). Lanes past the last matrix give no address that is
// read.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// An 8 x 8 matrix of 16-bit elements transposed across the warp: lane (g,
// t) gives row g, elements 2t, 2t + 1 (the low half first) and gets row
// g, elements 2t, 2t + 1 of the transpose
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

}  // namespace vst
