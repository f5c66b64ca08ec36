// K7: one-pass LayerNorm over the minor axis for Hopper.
//
// Replaces the JAX package's Pallas kernel ops/layer_norm.py `_kernel`
// (launched by `_fwd_call`).
//
// y[r, :] = (x[r, :] - mean_r) * rsqrt(var_r + eps) * scale + bias for
// every row r of a row-major (M, C) matrix, with f32 statistics and an
// f32 affine, rounded once at the output. scale and bias are read as
// they are held, in x's type or in f32, and widened in registers.
//
// Bound on the H100: ~8 flops per element against 2 * itemsize bytes of
// traffic is far below the ridge: the kernel is bound by device-memory
// bandwidth, 2 * M * C * itemsize bytes in all (scale and bias stay in
// L2). The design reads each element of x once and writes each element
// of y once.
//
// Design: one warp per row, 8 rows per block. A lane loads the row's
// 16-byte vectors lane, lane + 32, ... (neighbouring lanes on
// neighbouring addresses) and keeps them in registers as f32: at most
// MAXV vectors, so C <= 32 * MAXV * (16 / itemsize) (C = 1280 is 40
// values a lane). The mean, then the centred variance, are summed over
// those registers and across the warp by shuffles: two passes over
// registers, never E[x^2] - mean^2, so a large common offset does not
// cancel. Rows are independent, so any M is taken and the last block's
// spare warps leave at once. What the TPU kernel's blocking served (a
// block_m row tile, the MXU row-sum variant, rows % 8 and C % 128) has no
// counterpart here.

#include "common.cuh"

namespace vst {
namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One x-vector's worth (N values) of scale or bias, as f32.
template <typename S, int N>
__device__ __forceinline__ void load_affine(const S* p, float* out) {
  static_assert(N % Vec<S>::N == 0, "affine type wider than x's");
#pragma unroll
  for (int e = 0; e < N; e += Vec<S>::N) unpack16<S>(p + e, out + e);
}

template <typename T, typename S, int MAXV>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                      const S* __restrict__ bias, T* __restrict__ y,
                      long long m, int c, float eps) {
  constexpr int VEC = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp leaves together
  const int nvec = c / VEC;
  const T* xr = x + row * c;
  T* yr = y + row * c;

  float v[MAXV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int cv = lane + 32 * i;
    if (cv < nvec) {
      unpack16<T>(xr + cv * VEC, v[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sum += v[i][e];
    }
  }
  const float inv_c = 1.f / (float)c;
  const float mean = warp_sum(sum) * inv_c;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[i][e] -= mean;
        sq = fmaf(v[i][e], v[i][e], sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);

#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int cv = lane + 32 * i;
    if (cv < nvec) {
      float sc[VEC], bi[VEC], out[VEC];
      load_affine<S, VEC>(scale + cv * VEC, sc);
      load_affine<S, VEC>(bias + cv * VEC, bi);
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = v[i][e] * rstd * sc[e] + bi[e];
      pack16<T>(yr + cv * VEC, out);
    }
  }
}

template <typename T, typename S, int MAXV>
int launch(const void* x, const void* scale, const void* bias, void* y,
           long long m, int c, float eps, cudaStream_t stream) {
  const long long blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 2147483647LL) return -3;
  layer_norm_kernel<T, S, MAXV><<<(unsigned)blocks, kRowsPerBlock * 32, 0,
                                  stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const S*>(bias), static_cast<T*>(y), m, c, eps);
  return (int)cudaGetLastError();
}

// the smallest instance whose registers hold the row
template <typename T, typename S>
int dispatch(const void* x, const void* scale, const void* bias, void* y,
             long long m, int c, float eps, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (c <= 0 || c % VEC) return -2;
  const int per_lane = (c / VEC + 31) / 32;
  if (per_lane <= 1) return launch<T, S, 1>(x, scale, bias, y, m, c, eps, s);
  if (per_lane <= 2) return launch<T, S, 2>(x, scale, bias, y, m, c, eps, s);
  if (per_lane <= 4) return launch<T, S, 4>(x, scale, bias, y, m, c, eps, s);
  if (per_lane <= 8) return launch<T, S, 8>(x, scale, bias, y, m, c, eps, s);
  if constexpr (std::is_same<T, float>::value) {
    if (per_lane <= 16) return launch<T, S, 16>(x, scale, bias, y, m, c, eps, s);
  }
  return -2;
}

}  // namespace
}  // namespace vst

// x, y: (m, c) row-major of `dtype`; scale, bias: (c,) of `affine_dtype`,
// which is `dtype` or f32; all 16-byte aligned. c a multiple of
// 16 / itemsize of x, at most 2048.
extern "C" int vst_layer_norm_fwd(int dtype, int affine_dtype, const void* x,
                                  const void* scale, const void* bias,
                                  void* y, long long m, int c, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0) return -2;
  if (dtype == vst::kFloat32 && affine_dtype == vst::kFloat32)
    return vst::dispatch<float, float>(x, scale, bias, y, m, c, eps, s);
  if (dtype == vst::kBFloat16 && affine_dtype == vst::kFloat32)
    return vst::dispatch<vst::bf16, float>(x, scale, bias, y, m, c, eps, s);
  if (dtype == vst::kBFloat16 && affine_dtype == vst::kBFloat16)
    return vst::dispatch<vst::bf16, vst::bf16>(x, scale, bias, y, m, c, eps,
                                               s);
  return -1;
}
