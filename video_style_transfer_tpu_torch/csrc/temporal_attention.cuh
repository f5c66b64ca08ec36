// Device pieces that K3 (temporal_attention.cu) and K5
// (temporal_attention_bwd.cu) share: a pair's F x F products over its
// head dim on mma.sync (bf16 m16n8k16, fp32 at 3xTF32), a pair of
// outputs stored to shared memory. A (pixel, head) pair's F rows of one
// tensor lie in shared memory `row_bytes` apart; rows past F read a
// 16-byte zero row.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma_sync.cuh"

namespace vst {
namespace ta {

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(x, y);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// S (16 x 8 NT) = Q K^T for row tile mt of one pair (K5 also dP = dO V^T)
// over its first d columns: bf16 on m16n8k16 with an m16n8k8 tail, fp32
// at 3xTF32 in 64-column chunks
template <typename T, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], uint32_t qb,
                                       uint32_t kb, int mt, int frames,
                                       int d, int row_bytes, uint32_t zero,
                                       int lane) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  constexpr int KP = (NT + 1) / 2;  // pairs of n tiles (a phantom past NT)
  // x4 lanes: Q rows mt*16 + (lane & 7) + 8 * bit 3, columns + 16 bytes
  // at bit 4; K rows 8 * (2p + bit 4) + (lane & 7), columns + 16 bytes at
  // bit 3
  const int qrow = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t qa = qb + qrow * row_bytes;  // read where qrow < F
  const uint32_t qoff = (lane >> 4) * 16;
  const bool qok = qrow < frames;
  uint32_t ka[KP], koff = ((lane >> 3) & 1) * 16;
  bool kok[KP];
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const int krow = 8 * (2 * p + (lane >> 4)) + (lane & 7);
    ka[p] = kb + krow * row_bytes;
    kok[p] = krow < frames;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  const int bytes = d * (int)sizeof(T);
  if constexpr (BF16) {
    int c = 0;  // byte column
    for (; c + 32 <= bytes; c += 32) {
      uint32_t a[4];
      ldmatrix_x4(a, qok ? qa + qoff + c : zero);
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, kok[p] ? ka[p] + koff + c : zero);
        mma_16816(s[2 * p], a, {b[0], b[1]});
        if (2 * p + 1 < NT) mma_16816(s[2 * p + 1], a, {b[2], b[3]});
      }
    }
    if (c < bytes) {  // d % 16 = 8: one m16n8k8 step
      uint32_t a[2];
      ldmatrix_x2(a, qok ? qa + c : zero);  // lanes 0-15: rows, no offset
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        // lanes 0-7 tile 2p, 8-15 tile 2p + 1, column c
        const int krow = 8 * (2 * p + ((lane >> 3) & 1)) + (lane & 7);
        uint32_t b[2];
        ldmatrix_x2(b, krow < frames ? kb + krow * row_bytes + c : zero);
        mma_1688(s[2 * p], a[0], a[1], b[0]);
        if (2 * p + 1 < NT) mma_1688(s[2 * p + 1], a[0], a[1], b[1]);
      }
    }
  } else {
    // 8 fp32 columns (32 bytes) a k step; each chunk of 8 steps summed
    // from zero, then added
    for (int c0 = 0; c0 < bytes; c0 += 256) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
      const int c1 = min(bytes, c0 + 256);
      for (int c = c0; c < c1; c += 32) {
        uint32_t a[4];
        ldmatrix_x4(a, qok ? qa + qoff + c : zero);
        FragA fa;
        split_a(fa, {__uint_as_float(a[0]), __uint_as_float(a[1]),
                     __uint_as_float(a[2]), __uint_as_float(a[3])});
#pragma unroll
        for (int p = 0; p < KP; ++p) {
          uint32_t b[4];
          ldmatrix_x4(b, kok[p] ? ka[p] + koff + c : zero);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (2 * p + h < NT) {
              FragB fb;
              split(__uint_as_float(b[2 * h]), fb.hi[0], fb.lo[0]);
              split(__uint_as_float(b[2 * h + 1]), fb.hi[1], fb.lo[1]);
              mma3<false>(part[2 * p + h], fa, fb);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
    }
  }
}

}  // namespace ta
}  // namespace vst
