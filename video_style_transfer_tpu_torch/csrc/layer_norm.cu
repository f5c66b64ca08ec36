// K7: one-pass LayerNorm over the minor axis for Hopper.
//
// Replaces the JAX package's Pallas kernel ops/layer_norm.py `_kernel`
// (launched by `_fwd_call`).
//
// y[r, :] = (x[r, :] - mean_r) * rsqrt(var_r + eps) * scale + bias for
// every row r of a row-major (M, C) matrix, with f32 statistics and an
// f32 affine, rounded once at the output. scale and bias are read as
// they are held, in x's type or in f32, and widened in registers. Where
// a gradient will be taken, the row's mean and rstd = rsqrt(var + eps)
// are also written, as f32 (M,) vectors: the backward (aten's
// native_layer_norm_backward, ops/layer_norm.py) reads them instead of
// summing the rows again.
//
// Bound on the H100: ~8 flops per element against 2 * itemsize bytes of
// traffic is far below the ridge: the kernel is bound by device-memory
// bandwidth, 2 * M * C * itemsize bytes in all (scale and bias stay in
// L2; the statistics add 8 bytes a row). The design reads each element
// of x once and writes each element of y once.
//
// Design: one warp per row, `rows` (1-8) rows per block, chosen by the
// caller from M (ops/layer_norm.py:rows_per_block): 8 where that still
// gives every SM a block, fewer for small M (the text encoders' 77-154
// rows, stage 1's 1024), so that the grid covers the SMs where M allows.
// A lane loads the row's 16-byte vectors lane, lane + 32, ...
// (neighbouring lanes on neighbouring addresses) and keeps them in
// registers as f32: at most MAXV vectors, so C <= 32 * MAXV * (16 /
// itemsize) (C = 1280 is 40 values a lane). The mean, then the centred
// variance, are summed over those registers and across the warp by
// shuffles: two passes over registers, never E[x^2] - mean^2, so a large
// common offset does not cancel. Rows are independent, so any M is taken
// and the last block's spare warps leave at once. What the TPU kernel's
// blocking served (a block_m row tile, the MXU row-sum variant, rows % 8
// and C % 128) has no counterpart here.
//
// The arguments come packed in one struct (LayerNormCall, packed by
// ops/layer_norm.py), so a call costs the host one ctypes argument.
//
// The backward's dscale and dbias (layer_norm_affine_grad_kernel and
// layer_norm_affine_grad_finish_kernel), for the LayerNorms whose
// parameters are trained (stage 2's motion modules): column sums over all
// M rows of g * (x - mean_r) * rstd_r and of g. They replace no TPU
// kernel: the JAX package takes the whole backward from XLA
// (ops/layer_norm.py `_ln_bwd`, jax.vjp of `_reference`); the port takes
// dx from aten's native_layer_norm_backward, whose own bf16 dscale and
// dbias at stage 2's motion level 0 (131072 rows) read 2.4e-3 to 2.7e-3
// normwise from the plain formula's autograd, bf16 against bf16, on an
// H100 (chip_smoke.py: layer_norm_phases reports it on every run), past
// the backward limit of 2^-10.
// Bound by device-memory bandwidth: x and g read once, 2 * M * C *
// itemsize bytes (the partial sums add 8 * C bytes a block). Design: one
// warp a run of rows (`rows_per_warp`, chosen by the caller so that the
// grid is about two blocks an SM), each lane the same columns as in the
// forward, its sums in f32 registers; the block's 8 warps add theirs in
// shared memory in a fixed order and write one f32 row of partial sums;
// the finish kernel, launched behind it in the same call, sums each
// column's partials in float64 in block order and rounds once to the
// affine's dtype (the result does not depend on the schedule).

#include <cstddef>

#include "common.cuh"

namespace vst {

struct LayerNormCall {
  const void* x;
  const void* scale;
  const void* bias;
  void* y;
  float* mean;  // (m,) f32, or nullptr: no statistics
  float* rstd;  // (m,) f32, written together with mean
  void* stream;
  long long m;
  int c, device, dtype, affine_dtype, rows;
  float eps;
};

struct LayerNormAffineGradCall {
  const void* x;
  const void* g;
  const float* mean;  // (m,) f32, the forward's
  const float* rstd;  // (m,) f32, the forward's
  float* partial;     // (2, blocks, c) f32: dscale's, then dbias's sums
  void* out;          // (2, c) of out_dtype: dscale, then dbias
  void* stream;
  long long m;
  int c, device, dtype, out_dtype, rows_per_warp, blocks;
};

namespace {

constexpr int kMaxRowsPerBlock = 8;
constexpr int kMaxChannels = 2048;

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

template <typename T, typename S, int MAXV, bool STATS>
__global__ void __launch_bounds__(kMaxRowsPerBlock * 32)
    layer_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                      const S* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, long long m, int c,
                      float eps) {
  constexpr int VEC = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
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
  if constexpr (STATS) {
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }

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
int launch(const LayerNormCall& call) {
  const long long blocks = (call.m + call.rows - 1) / call.rows;
  if (blocks > 2147483647LL) return -3;
  // the statistics' stores are compiled in only where asked for: a branch
  // on the pointer cost the image path's (2048, 1280) row ~1-2 % on an
  // H100
  auto kernel = call.mean != nullptr ? layer_norm_kernel<T, S, MAXV, true>
                                     : layer_norm_kernel<T, S, MAXV, false>;
  kernel<<<(unsigned)blocks, call.rows * 32, 0,
           static_cast<cudaStream_t>(call.stream)>>>(
      static_cast<const T*>(call.x), static_cast<const S*>(call.scale),
      static_cast<const S*>(call.bias), static_cast<T*>(call.y), call.mean,
      call.rstd, call.m, call.c, call.eps);
  return (int)cudaGetLastError();
}

// the smallest instance whose registers hold the row; C = 1280 (5 vectors
// a lane in bf16, 10 in f32) has one of its own, which holds no unused
// vector (the one of 8 ran its UNet level-2 row 13 % slower on an H100)
template <typename T, typename S>
int dispatch(const LayerNormCall& call) {
  constexpr int VEC = Vec<T>::N;
  if (call.c <= 0 || call.c % VEC) return -2;
  const int per_lane = (call.c / VEC + 31) / 32;
  if (per_lane <= 1) return launch<T, S, 1>(call);
  if (per_lane <= 2) return launch<T, S, 2>(call);
  if (per_lane <= 4) return launch<T, S, 4>(call);
  if (per_lane <= 5) return launch<T, S, 5>(call);
  if (per_lane <= 8) return launch<T, S, 8>(call);
  if constexpr (std::is_same<T, float>::value) {
    if (per_lane <= 10) return launch<T, S, 10>(call);
    if (per_lane <= 16) return launch<T, S, 16>(call);
  }
  return -2;
}

int layer_norm_fwd(const LayerNormCall& call) {
  if (call.m <= 0 || call.rows < 1 || call.rows > kMaxRowsPerBlock ||
      (call.mean == nullptr) != (call.rstd == nullptr))
    return -2;
  if (call.dtype == kFloat32 && call.affine_dtype == kFloat32)
    return dispatch<float, float>(call);
  if (call.dtype == kBFloat16 && call.affine_dtype == kFloat32)
    return dispatch<bf16, float>(call);
  if (call.dtype == kBFloat16 && call.affine_dtype == kBFloat16)
    return dispatch<bf16, bf16>(call);
  return -1;
}

template <typename T, int MAXV>
__global__ void __launch_bounds__(kMaxRowsPerBlock * 32)
    layer_norm_affine_grad_kernel(const T* __restrict__ x,
                                  const T* __restrict__ g,
                                  const float* __restrict__ mean,
                                  const float* __restrict__ rstd,
                                  float* __restrict__ partial, long long m,
                                  int c, int rows_per_warp) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float sums[2][kMaxChannels];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;  // the warp in the block
  const long long warp = (long long)blockIdx.x * kMaxRowsPerBlock + wib;
  const int nvec = c / VEC;
  float ds[MAXV][VEC], db[MAXV][VEC];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[i][e] = db[i][e] = 0.f;
  }
  // a warp past the last row sums nothing but still takes part below
  const long long r0 = warp * rows_per_warp;
  const long long r1 = r0 + rows_per_warp < m ? r0 + rows_per_warp : m;
  for (long long r = r0; r < r1; ++r) {
    const float mu = mean[r], rs = rstd[r];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int cv = lane + 32 * i;
      if (cv < nvec) {
        float xv[VEC], gv[VEC];
        unpack16<T>(x + r * c + cv * VEC, xv);
        unpack16<T>(g + r * c + cv * VEC, gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ds[i][e] = fmaf(gv[e], (xv[e] - mu) * rs, ds[i][e]);
          db[i][e] += gv[e];
        }
      }
    }
  }
  // the block's warps add their sums into shared memory one after the
  // other, in a fixed order
  for (int w = 0; w < kMaxRowsPerBlock; ++w) {
    if (wib == w) {
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int cv = lane + 32 * i;
        if (cv < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int k = cv * VEC + e;
            sums[0][k] = w == 0 ? ds[i][e] : sums[0][k] + ds[i][e];
            sums[1][k] = w == 0 ? db[i][e] : sums[1][k] + db[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pds = partial + (long long)blockIdx.x * c;
  float* pdb = partial + ((long long)gridDim.x + blockIdx.x) * c;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    pds[k] = sums[0][k];
    pdb[k] = sums[1][k];
  }
}

// out[w, k] = the sum over the blocks of partial[w, block, k] (w = 0:
// dscale, 1: dbias), in float64 in block order, rounded once to O: one
// thread a column of each, neighbouring threads on neighbouring columns
template <typename O>
__global__ void __launch_bounds__(256)
    layer_norm_affine_grad_finish_kernel(const float* __restrict__ partial,
                                         O* __restrict__ out, int blocks,
                                         int c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * c) return;
  const int w = k / c, col = k - w * c;
  const float* p = partial + (long long)w * blocks * c + col;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += (double)p[(long long)b * c];
  out[k] = from_f<O>((float)s);
}

template <typename T, int MAXV>
int launch_affine_grad(const LayerNormAffineGradCall& call) {
  const cudaStream_t stream = static_cast<cudaStream_t>(call.stream);
  layer_norm_affine_grad_kernel<T, MAXV>
      <<<call.blocks, kMaxRowsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(call.x), static_cast<const T*>(call.g),
          call.mean, call.rstd, call.partial, call.m, call.c,
          call.rows_per_warp);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const unsigned grid = (unsigned)((2 * call.c + 255) / 256);
  if (call.out_dtype == kFloat32)
    layer_norm_affine_grad_finish_kernel<float><<<grid, 256, 0, stream>>>(
        call.partial, static_cast<float*>(call.out), call.blocks, call.c);
  else
    layer_norm_affine_grad_finish_kernel<bf16><<<grid, 256, 0, stream>>>(
        call.partial, static_cast<bf16*>(call.out), call.blocks, call.c);
  return (int)cudaGetLastError();
}

// the smallest instance whose registers hold a lane's share of the row
// (the models' widths: 2, 3 or 5 vectors a lane in bf16, 3, 5 or 10 in
// f32, so that no unused sums take registers)
template <typename T>
int dispatch_affine_grad(const LayerNormAffineGradCall& call) {
  constexpr int VEC = Vec<T>::N;
  if (call.c <= 0 || call.c % VEC || call.c > kMaxChannels) return -2;
  const int per_lane = (call.c / VEC + 31) / 32;
  if (per_lane <= 1) return launch_affine_grad<T, 1>(call);
  if (per_lane <= 2) return launch_affine_grad<T, 2>(call);
  if (per_lane <= 3) return launch_affine_grad<T, 3>(call);
  if (per_lane <= 4) return launch_affine_grad<T, 4>(call);
  if (per_lane <= 5) return launch_affine_grad<T, 5>(call);
  if (per_lane <= 8) return launch_affine_grad<T, 8>(call);
  if constexpr (std::is_same<T, float>::value) {
    if (per_lane <= 10) return launch_affine_grad<T, 10>(call);
    if (per_lane <= 16) return launch_affine_grad<T, 16>(call);
  }
  return -2;
}

int layer_norm_affine_grad(const LayerNormAffineGradCall& call) {
  if (call.m <= 0 || call.rows_per_warp < 1 || call.blocks < 1 ||
      (long long)call.blocks * kMaxRowsPerBlock * call.rows_per_warp <
          call.m ||
      (call.out_dtype != kFloat32 && call.out_dtype != kBFloat16))
    return -2;
  if (call.dtype == kFloat32) return dispatch_affine_grad<float>(call);
  if (call.dtype == kBFloat16) return dispatch_affine_grad<bf16>(call);
  return -1;
}

}  // namespace
}  // namespace vst

static_assert(offsetof(vst::LayerNormAffineGradCall, m) == 56 &&
                  offsetof(vst::LayerNormAffineGradCall, blocks) == 84 &&
                  sizeof(vst::LayerNormAffineGradCall) == 88,
              "LayerNormAffineGradCall must match ops/layer_norm.py's "
              "packing");

static_assert(offsetof(vst::LayerNormCall, m) == 56 &&
                  offsetof(vst::LayerNormCall, eps) == 84 &&
                  sizeof(vst::LayerNormCall) == 88,
              "LayerNormCall must match ops/layer_norm.py's packing");

// One K7 call from its packed arguments: x, y (m, c) row-major of
// `dtype`; scale, bias (c,) of `affine_dtype`, which is `dtype` or f32;
// all 16-byte aligned; c a multiple of 16 / itemsize of x, at most 2048.
// Launched on the call's device, made current for the launch where
// another one is.
extern "C" int vst_layer_norm_fwd(const vst::LayerNormCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::layer_norm_fwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::layer_norm_fwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}

// The backward's dscale and dbias from packed arguments: x, g (m, c)
// row-major of `dtype`, mean and rstd (m,) f32, all 16-byte aligned, c at
// most 2048; each warp of `blocks` blocks of 8 sums `rows_per_warp` rows,
// each block writes its warps' sums as one row of `partial` (2, blocks,
// c) f32, and the finish kernel writes their sums to `out` (2, c) of
// `out_dtype` (f32 or bf16).
extern "C" int vst_layer_norm_affine_grad(
    const vst::LayerNormAffineGradCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::layer_norm_affine_grad(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::layer_norm_affine_grad(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
