// K3: per-pixel temporal (frame-axis) attention forward for Hopper.
//
// Replaces the JAX package's Pallas kernel ops/temporal_attention.py
// `_kernel` (launched by `_fwd_kernel_call`).
//
// For every pixel n and head h independently: logits[f][g] =
// q[f,n,h,:] . k[g,n,h,:] * scale over the F <= 32 frames, a base-2
// softmax over g, and o[f,n,h,:] = sum_g w[f][g] v[g,n,h,:], with f32
// products and accumulation. q, k, v are (F, N, H, d) strided views (the
// motion module's fused (F, N, 3P) projection, read in place); the output
// is (F, N, H*d) contiguous.
//
// Bound on the H100: ~4*F*d flops per (f, n, h) output row against
// 4*d*bytes of q/k/v/o traffic is ~F/2 flops per byte at F = 16, far
// below the ridge: the kernel is bound by device-memory bandwidth. The
// design reads each q/k/v element once and writes each output once.
//
// Design: a block takes PAIRS (pixel, head) pairs (up to 8 in 48 KB; one
// above that, up to a block's 227 KB); each pair's F x d
// q, k and v land in shared memory through 16-byte loads (d = 40, 80,
// 160 on the serving path are not powers of two, so d is walked in
// 8-element vectors, never padded). DS = 4 threads share one (pair,
// frame) query row: each sums its share of the vectors into F partial
// logits held in registers (F <= 32 is a template bound), the partials
// meet through warp shuffles, every thread of the group runs the same
// softmax, and each writes its own vectors of the output over its own q
// slots in shared memory, from where the block stores coalesced rows.

#include "common.cuh"

namespace vst {
namespace {

constexpr int DS = 4;  // threads per (pair, frame) row

struct TAArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int frames, n, heads, head_dim, pairs;
  long long q_sf, q_sn, q_sh;
  long long k_sf, k_sn, k_sh;
  long long v_sf, v_sn, v_sh;
  float scale;
};

template <typename T, int MAXF>
__global__ void ta_fwd_kernel(const TAArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = Vec<T>::N;
  const int F = a.frames, d = a.head_dim, nvec = d / VEC;
  const int pairs = a.pairs;
  T* qs = reinterpret_cast<T*>(smem);  // [pairs][F][d]; later the output
  T* ks = qs + pairs * F * d;
  T* vs = ks + pairs * F * d;
  const long long total = (long long)a.n * a.heads;
  const long long pair0 = (long long)blockIdx.x * pairs;
  const int tid = threadIdx.x;

  const int per_pair = F * nvec;
  for (int i = tid; i < pairs * per_pair; i += blockDim.x) {
    const int p = i / per_pair, rem = i - p * per_pair;
    const int f = rem / nvec, cv = rem - f * nvec;
    const long long gp = pair0 + p;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), kv = qv, vv = qv;
    if (gp < total) {
      const long long n = gp / a.heads;
      const long long h = gp - n * a.heads;
      const long long off = (long long)cv * VEC;
      qv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.q) + f * a.q_sf + n * a.q_sn + h * a.q_sh + off));
      kv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.k) + f * a.k_sf + n * a.k_sn + h * a.k_sh + off));
      vv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.v) + f * a.v_sf + n * a.v_sn + h * a.v_sh + off));
    }
    const int s_off = (p * F + f) * d + cv * VEC;
    *reinterpret_cast<uint4*>(qs + s_off) = qv;
    *reinterpret_cast<uint4*>(ks + s_off) = kv;
    *reinterpret_cast<uint4*>(vs + s_off) = vv;
  }
  __syncthreads();

  // thread -> (pair pl, frame f, share s); threads past the last pair
  // compute on zeros so every lane takes part in the shuffles
  const int pl = tid / (F * DS);
  const int rem = tid - pl * (F * DS);
  const int f = rem / DS, s = rem - (rem / DS) * DS;
  const bool active = pl < pairs;

  float lg[MAXF];
#pragma unroll
  for (int g = 0; g < MAXF; ++g) lg[g] = 0.f;
  if (active) {
    const T* qrow = qs + (pl * F + f) * d;
    for (int cv = s; cv < nvec; cv += DS) {
      float qf[VEC];
      unpack16<T>(qrow + cv * VEC, qf);
#pragma unroll
      for (int g = 0; g < MAXF; ++g) {
        if (g < F) {
          float kf[VEC];
          unpack16<T>(ks + (pl * F + g) * d + cv * VEC, kf);
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc = fmaf(qf[e], kf[e], acc);
          lg[g] += acc;
        }
      }
    }
  }
  const float s2 = a.scale * kLog2e;
  float mx = -INFINITY;
#pragma unroll
  for (int g = 0; g < MAXF; ++g) {
    if (g < F) {
      lg[g] += __shfl_xor_sync(0xffffffffu, lg[g], 1);
      lg[g] += __shfl_xor_sync(0xffffffffu, lg[g], 2);
      lg[g] *= s2;
      mx = fmaxf(mx, lg[g]);
    }
  }
  float den = 0.f;
#pragma unroll
  for (int g = 0; g < MAXF; ++g) {
    if (g < F) {
      lg[g] = exp2f(lg[g] - mx);
      den += lg[g];
    }
  }
  const float inv = 1.f / den;

  if (active) {
    T* orow = qs + (pl * F + f) * d;  // only this thread read these vectors
    for (int cv = s; cv < nvec; cv += DS) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int g = 0; g < MAXF; ++g) {
        if (g < F) {
          float vf[VEC];
          unpack16<T>(vs + (pl * F + g) * d + cv * VEC, vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = fmaf(lg[g], vf[e], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= inv;
      pack16<T>(orow + cv * VEC, acc);
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  const long long p_dim = (long long)a.heads * d;
  for (int i = tid; i < pairs * per_pair; i += blockDim.x) {
    const int p = i / per_pair, r2 = i - p * per_pair;
    const int ff = r2 / nvec, cv = r2 - ff * nvec;
    const long long gp = pair0 + p;
    if (gp >= total) continue;
    const long long n = gp / a.heads;
    const long long h = gp - n * a.heads;
    *reinterpret_cast<uint4*>(o + ((long long)ff * a.n + n) * p_dim +
                              h * d + cv * VEC) =
        *reinterpret_cast<const uint4*>(qs + (p * F + ff) * d + cv * VEC);
  }
}

// shared memory one block may take on Hopper (227 KB of the SM's 256)
constexpr size_t kMaxBlockSmem = 232448;

template <typename T, int MAXF>
int launch(TAArgs a, cudaStream_t stream) {
  // as many (pixel, head) pairs per block as fit 48 KB of shared memory,
  // at most 8 (F * DS * 8 <= 1024 threads); a pair above 48 KB (fp32 clips
  // of 26 or more frames at d = 160) takes a block of its own, with the
  // dynamic shared-memory ceiling raised as far as a block's limit
  // (ops/temporal_attention.py's `pair_fits` makes the same test)
  const size_t per_pair = 3 * (size_t)a.frames * a.head_dim * sizeof(T);
  if (per_pair > kMaxBlockSmem) return -4;
  int pairs = (int)((48 * 1024) / per_pair);
  pairs = pairs < 1 ? 1 : (pairs > 8 ? 8 : pairs);
  a.pairs = pairs;
  const size_t smem = per_pair * pairs;
  auto kern = ta_fwd_kernel<T, MAXF>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (pairs * a.frames * DS + 31) / 32 * 32;
  const long long total = (long long)a.n * a.heads;
  const long long blocks = (total + pairs - 1) / pairs;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_f(const TAArgs& a, cudaStream_t s) {
  if (a.frames <= 8) return launch<T, 8>(a, s);
  if (a.frames <= 16) return launch<T, 16>(a, s);
  if (a.frames <= 32) return launch<T, 32>(a, s);
  return -2;
}

}  // namespace
}  // namespace vst

extern "C" int vst_temporal_attention_fwd(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int frames, int n, int heads, int head_dim, long long q_sf,
    long long q_sn, long long q_sh, long long k_sf, long long k_sn,
    long long k_sh, long long v_sf, long long v_sn, long long v_sh,
    float scale, void* stream) {
  vst::TAArgs a{q,    k,    v,    o,    frames, n,    heads, head_dim, 0,
                q_sf, q_sn, q_sh, k_sf, k_sn,   k_sh, v_sf,  v_sn,     v_sh,
                scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vst::kFloat32) return vst::dispatch_f<float>(a, s);
  if (dtype == vst::kBFloat16) return vst::dispatch_f<vst::bf16>(a, s);
  return -1;
}
