// GroupNorm, and GroupNorm followed by SiLU, over channels-last
// activations for Hopper.
//
// Replaces no TPU kernel: the JAX package's GroupNorm is XLA
// (video_style_transfer_tpu/models/layers.py:group_norm), which fuses the
// statistics and the affine into its neighbours. In eager PyTorch the
// same formula is about eleven launches a call (an fp32 copy of x, its
// var_mean, the scale and shift, a broadcast addcmul back to x's dtype)
// and a SiLU pass of its own; every GroupNorm of the port's UNet and VAE
// comes here instead (ops/group_norm.py).
//
// For x (rows, positions, c) row-major, groups g of c / groups channels:
//   y[r, p, ch] = x[r, p, ch] * scale[r, ch] + shift[r, ch],
//   scale = rsqrt(var[r, g] + eps) * weight[ch],
//   shift = bias[ch] - mean[r, g] * scale,
// mean and (biased) var over every position and channel of (r, g), in f32;
// y is rounded once to x's dtype, and with `silu` that rounded value is
// taken back to f32, put through v / (1 + exp(-v)) and rounded again,
// which is F.silu of the unfused output.
//
// Bound on the H100: a few flops an element against 3 * itemsize bytes
// (x read twice, y written once) is far below the ridge, so the design
// moves no byte beyond those: no f32 copy of x, no second pass for SiLU.
//
// Design: two kernels on one plan (ops/group_norm.py:launch_plan), both a
// grid of (row, chunk of positions) blocks, one wave of resident blocks
// where the rows allow it. A block of `threads` = k * (c / VEC) threads
// takes k positions a step: thread t owns the 16-byte vector t % (c /
// VEC) of every position it visits, so its channels never change and
// neighbouring threads read neighbouring addresses. A group may start
// inside a vector (c / groups = 10 or 30 in bf16): channels are mapped to
// groups one by one, never by vector.
// - vst_gn_stats_kernel: each thread keeps a Welford (mean, M2) per
//   channel of its vector over its positions, four vectors in flight; the
//   block merges them per group in shared memory (count-weighted mean,
//   then M2 with the spread of the parts' means), warp sums in a fixed
//   order, and writes one f32 (mean, M2) a (row, group, chunk).
// - vst_gn_apply_kernel: each block merges its row's partials by Chan's
//   formula in chunk order (lanes, then a shuffle tree), so every block of
//   a row computes the same bits and a call gives the same bits every
//   run; forms its threads' f32 scale and shift in registers, streams x
//   once more and writes y with 16-byte stores.
// The arguments come packed in one struct (GroupNormCall, packed by
// ops/group_norm.py); no allocation, no host synchronisation.

#include <cstddef>

#include "common.cuh"

namespace vst {

struct GroupNormCall {
  const void* x;
  const void* weight;
  const void* bias;
  void* y;
  float2* partial;  // (rows, groups, chunks) of (mean, M2), f32
  void* stream;
  long long rows, positions;
  long long chunk;  // positions a chunk (a row's last may hold fewer)
  int c, groups, chunks, threads, device, dtype, affine_dtype, silu;
  float eps;
};

namespace {

// a stats block's per-thread statistics, threads * VEC floats each of mean
// and M2 (32 KB of shared memory in all), bound a block's threads: 512 in
// bf16, 1024 in f32. The launch bounds ask for 1024 threads an SM, 64
// registers a thread, so that two bf16 blocks fit an SM
constexpr int kStatFloats = 4096;
constexpr int kMaxGroups = 1024;
template <typename T>
struct Bounds {
  static constexpr int threads = kStatFloats / Vec<T>::N;
  static constexpr int blocks = 1024 / threads;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (n, mean, m2) <- its merge with (nb, mb, m2b) (Chan et al.); a part of
// count 0 leaves it as it is, and a first part is taken as it is
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  const float f = nb / nn;
  mean = fmaf(d, f, mean);
  m2 = m2 + m2b + d * d * n * f;
  n = nn;
}

// positions of a chunk of `len` that the thread at slot j of k visits
__device__ __forceinline__ int slot_count(long long len, int j, int k) {
  return j < len ? (int)((len - j + k - 1) / k) : 0;
}

template <typename T>
__device__ __forceinline__ void welford(float (&mean)[Vec<T>::N],
                                        float (&m2)[Vec<T>::N],
                                        const float (&v)[Vec<T>::N],
                                        float r) {
#pragma unroll
  for (int e = 0; e < Vec<T>::N; ++e) {
    const float d = v[e] - mean[e];
    mean[e] = fmaf(d, r, mean[e]);
    m2[e] = fmaf(d, v[e] - mean[e], m2[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(Bounds<T>::threads, Bounds<T>::blocks)
    vst_gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial,
                        long long positions, long long chunk, int c,
                        int groups, int chunks) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float s_mean[kStatFloats];
  __shared__ float s_m2[kStatFloats];
  const int nv = c / VEC;
  const int k = blockDim.x / nv;
  const int t = threadIdx.x;
  const int j = t / nv, v = t - j * nv;
  const long long row = blockIdx.x / chunks;
  const int ck = (int)(blockIdx.x - row * chunks);
  const long long p0 = (long long)ck * chunk;
  const long long p1 = p0 + chunk < positions ? p0 + chunk : positions;
  const long long len = p1 - p0;
  const T* xr = x + row * positions * c + (long long)v * VEC;

  float mean[VEC], m2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) mean[e] = m2[e] = 0.f;
  int n = 0;
  long long p = p0 + j;
  for (; p + 3LL * k < p1; p += 4LL * k) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = *reinterpret_cast<const uint4*>(xr + (p + (long long)u * k) *
                                                        c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float a[VEC];
      unpack16<T>(reinterpret_cast<const T*>(&raw[u]), a);
      ++n;
      welford<T>(mean, m2, a, 1.f / (float)n);
    }
  }
  for (; p < p1; p += k) {
    float a[VEC];
    unpack16<T>(xr + p * c, a);
    ++n;
    welford<T>(mean, m2, a, 1.f / (float)n);
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s_mean[j * c + v * VEC + e] = mean[e];
    s_m2[j * c + v * VEC + e] = m2[e];
  }
  __syncthreads();

  // each group over the block's k slots and its channels, a warp a group:
  // the count-weighted mean, then M2 with the spread of the parts' means
  const int cpg = c / groups;
  const int lane = t & 31, warps = blockDim.x >> 5;
  const int entries = k * cpg;
  const float total = (float)(len * cpg);
  for (int g = t >> 5; g < groups; g += warps) {
    float s = 0.f;
    for (int i = lane; i < entries; i += 32) {
      const int jj = i / cpg;
      const int at = jj * c + g * cpg + (i - jj * cpg);
      s = fmaf((float)slot_count(len, jj, k), s_mean[at], s);
    }
    const float gm = warp_sum(s) / total;
    float q = 0.f;
    for (int i = lane; i < entries; i += 32) {
      const int jj = i / cpg;
      const int at = jj * c + g * cpg + (i - jj * cpg);
      const float d = s_mean[at] - gm;
      q += fmaf((float)slot_count(len, jj, k) * d, d, s_m2[at]);
    }
    const float gm2 = warp_sum(q);
    if (lane == 0)
      partial[(row * groups + g) * chunks + ck] = make_float2(gm, gm2);
  }
}

template <typename T, bool SILU>
__device__ __forceinline__ void affine_out(T* dst,
                                           const float (&a)[Vec<T>::N],
                                           const float (&sc)[Vec<T>::N],
                                           const float (&sh)[Vec<T>::N]) {
  constexpr int VEC = Vec<T>::N;
  float o[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    o[e] = fmaf(a[e], sc[e], sh[e]);
    if constexpr (SILU) {
      // F.silu of the rounded GroupNorm output, as the unfused path
      // computes it: its expf and division
      const float r = to_f<T>(from_f<T>(o[e]));
      o[e] = r / (1.f + expf(-r));
    }
  }
  pack16<T>(dst, o);
}

template <typename T, typename S, bool SILU>
__global__ void __launch_bounds__(Bounds<T>::threads, Bounds<T>::blocks)
    vst_gn_apply_kernel(const T* __restrict__ x, const S* __restrict__ weight,
                        const S* __restrict__ bias, T* __restrict__ y,
                        const float2* __restrict__ partial,
                        long long positions, long long chunk, int c,
                        int groups, int chunks, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float s_mean[kMaxGroups];
  __shared__ float s_rstd[kMaxGroups];
  const int nv = c / VEC;
  const int k = blockDim.x / nv;
  const int t = threadIdx.x;
  const int j = t / nv, v = t - j * nv;
  const long long row = blockIdx.x / chunks;
  const int ck = (int)(blockIdx.x - row * chunks);
  const int cpg = c / groups;
  const int lane = t & 31, warps = blockDim.x >> 5;

  // the row's statistics: each group's partials merged in chunk order,
  // lane by lane, then down a shuffle tree into lane 0
  for (int g = t >> 5; g < groups; g += warps) {
    const float2* pg = partial + (row * groups + g) * chunks;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int i = lane; i < chunks; i += 32) {
      const float2 q = pg[i];
      const long long rest = positions - (long long)i * chunk;
      chan_merge(n, mean, m2, (float)((rest < chunk ? rest : chunk) * cpg),
                 q.x, q.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, o);
      const float mb = __shfl_down_sync(0xffffffffu, mean, o);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, o);
      if (lane + o < 32) chan_merge(n, mean, m2, nb, mb, m2b);
    }
    if (lane == 0) {
      s_mean[g] = mean;
      s_rstd[g] = rsqrtf(m2 / n + eps);
    }
  }
  __syncthreads();

  float sc[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = v * VEC + e;
    const int g = ch / cpg;
    sc[e] = s_rstd[g] * to_f<S>(weight[ch]);
    sh[e] = to_f<S>(bias[ch]) - s_mean[g] * sc[e];
  }

  const long long p0 = (long long)ck * chunk;
  const long long p1 = p0 + chunk < positions ? p0 + chunk : positions;
  const long long off = row * positions * c + (long long)v * VEC;
  const T* xr = x + off;
  T* yr = y + off;
  long long p = p0 + j;
  for (; p + 3LL * k < p1; p += 4LL * k) {
    uint4 raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      raw[u] = *reinterpret_cast<const uint4*>(xr + (p + (long long)u * k) *
                                                        c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float a[VEC];
      unpack16<T>(reinterpret_cast<const T*>(&raw[u]), a);
      affine_out<T, SILU>(yr + (p + (long long)u * k) * c, a, sc, sh);
    }
  }
  for (; p < p1; p += k) {
    float a[VEC];
    unpack16<T>(xr + p * c, a);
    affine_out<T, SILU>(yr + p * c, a, sc, sh);
  }
}

template <typename T, typename S, bool SILU>
int launch(const GroupNormCall& call) {
  const cudaStream_t stream = static_cast<cudaStream_t>(call.stream);
  const unsigned grid = (unsigned)(call.rows * call.chunks);
  vst_gn_stats_kernel<T><<<grid, call.threads, 0, stream>>>(
      static_cast<const T*>(call.x), call.partial, call.positions,
      call.chunk, call.c, call.groups, call.chunks);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  vst_gn_apply_kernel<T, S, SILU><<<grid, call.threads, 0, stream>>>(
      static_cast<const T*>(call.x), static_cast<const S*>(call.weight),
      static_cast<const S*>(call.bias), static_cast<T*>(call.y),
      call.partial, call.positions, call.chunk, call.c, call.groups,
      call.chunks, call.eps);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int dispatch_silu(const GroupNormCall& call) {
  return call.silu ? launch<T, S, true>(call) : launch<T, S, false>(call);
}

template <typename T>
int dispatch(const GroupNormCall& call) {
  if (call.affine_dtype == kFloat32) return dispatch_silu<T, float>(call);
  if (call.affine_dtype == kBFloat16) return dispatch_silu<T, bf16>(call);
  return -1;
}

// the plan's invariants (ops/group_norm.py:launch_plan keeps them)
bool plan_ok(long long rows, long long positions, long long chunk, int c,
             int groups, int chunks, int threads, int vec) {
  if (rows < 1 || positions < 1 || c < vec || c % vec || groups < 1 ||
      groups > kMaxGroups || c % groups || chunks < 1 || chunk < 1)
    return false;
  const int nv = c / vec;
  if (threads < 32 || threads * vec > kStatFloats || threads % 32 ||
      threads % nv)
    return false;
  // every chunk holds at least one position, and they cover the row
  if ((long long)(chunks - 1) * chunk >= positions ||
      (long long)chunks * chunk < positions)
    return false;
  return rows * chunks <= 2147483647LL;
}

int group_norm_fwd(const GroupNormCall& call) {
  const int vec = call.dtype == kBFloat16 ? 8 : 4;
  if (!plan_ok(call.rows, call.positions, call.chunk, call.c, call.groups,
               call.chunks, call.threads, vec))
    return -2;
  if (call.dtype == kFloat32) return dispatch<float>(call);
  if (call.dtype == kBFloat16) return dispatch<bf16>(call);
  return -1;
}

template <typename T, typename S, bool SILU>
int resident(int threads, int* blocks) {
  int stats = 0, apply = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &stats, vst_gn_stats_kernel<T>, threads, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &apply, vst_gn_apply_kernel<T, S, SILU>, threads, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = stats < apply ? stats : apply;
  return 0;
}

int group_norm_resident(int dtype, int affine_dtype, int silu, int threads,
                        int* blocks) {
  if (threads < 32 || threads > 1024) return -2;
  if (dtype == kBFloat16 && affine_dtype == kBFloat16)
    return silu ? resident<bf16, bf16, true>(threads, blocks)
                : resident<bf16, bf16, false>(threads, blocks);
  if (dtype == kBFloat16 && affine_dtype == kFloat32)
    return silu ? resident<bf16, float, true>(threads, blocks)
                : resident<bf16, float, false>(threads, blocks);
  if (dtype == kFloat32 && affine_dtype == kBFloat16)
    return silu ? resident<float, bf16, true>(threads, blocks)
                : resident<float, bf16, false>(threads, blocks);
  if (dtype == kFloat32 && affine_dtype == kFloat32)
    return silu ? resident<float, float, true>(threads, blocks)
                : resident<float, float, false>(threads, blocks);
  return -1;
}

}  // namespace
}  // namespace vst

static_assert(offsetof(vst::GroupNormCall, rows) == 48 &&
                  offsetof(vst::GroupNormCall, c) == 72 &&
                  offsetof(vst::GroupNormCall, eps) == 104 &&
                  sizeof(vst::GroupNormCall) == 112,
              "GroupNormCall must match ops/group_norm.py's packing");

// One GroupNorm call from its packed arguments: x, y (rows, positions, c)
// row-major of `dtype`, 16-byte aligned; weight, bias (c,) of
// `affine_dtype` (f32 or bf16); partial (rows, groups, chunks) float2
// scratch; the plan's threads, chunks and chunk (ops/group_norm.py:
// launch_plan). Two launches on the call's device, made current for them
// where another one is.
extern "C" int vst_group_norm_fwd(const vst::GroupNormCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::group_norm_fwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::group_norm_fwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}

// Blocks of `threads` that one SM of `device` holds at once of both
// kernels of a (dtype, affine_dtype, silu) instance, into *blocks: the
// plan's wave.
extern "C" int vst_group_norm_resident(int dtype, int affine_dtype, int silu,
                                       int threads, int device,
                                       int* blocks) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == device)
    return vst::group_norm_resident(dtype, affine_dtype, silu, threads,
                                    blocks);
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::group_norm_resident(dtype, affine_dtype, silu,
                                           threads, blocks);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
