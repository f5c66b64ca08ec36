// K5: per-pixel temporal (frame-axis) attention backward for Hopper.
//
// Replaces the JAX package's Pallas kernel ops/temporal_attention.py
// `_bwd_kernel` (launched by `_bwd_kernel_call`).
//
// For every pixel n and head h independently, over the F <= 32 frames:
// recompute w[f][g] = softmax_g(q_f . k_g * scale) (base 2, as K3), then
//   dp[f][g] = do_f . v_g,  delta_f = sum_g w[f][g] dp[f][g],
//   ds[f][g] = w[f][g] (dp[f][g] - delta_f) scale,
//   dq_f = sum_g ds[f][g] k_g,  dk_g = sum_f ds[f][g] q_f,
//   dv_g = sum_f w[f][g] do_f,
// all in f32, rounded once into the outputs. q, k, v are (F, N, H, d)
// strided views; dO is (F, N, H*d) contiguous; dq, dk, dv are written
// (F, N, H, d) contiguous.
//
// Bound on the H100: ~11 * F * d flops per (f, n, h) row (the JAX cost
// estimate) against 7 * d elements of traffic (q, k, v, dO in; dq, dk, dv
// out) is ~F flops per byte, far below the ridge: the kernel is bound by
// device-memory bandwidth. It reads each input element once and writes
// each output once.
//
// Design: a block takes PAIRS (pixel, head) pairs. Their q, k, v and dO
// rows land in shared memory through 16-byte loads ordered frame-major,
// so consecutive threads read consecutive pairs' contiguous rows. DS
// threads own one (pair, frame) row: DS is the largest of 4, 2, 1 that
// divides the d / VEC 16-byte vectors of a row (d = 40, 80, 160 are not
// powers of two), so every thread walks the same number of vectors and
// none idles (K3's fixed four-way split leaves one of four threads with
// twice the work at d = 40). Each thread keeps its row's F logits and
// F dp values in registers (F <= 32 is a template bound), partial dot
// products meet through warp shuffles, and the F x F w and ds matrices of
// each pair go through shared memory so that the thread of row g can sum
// column g for dk_g and dv_g. dq, dk and dv are staged in shared memory
// over buffers their inputs no longer need and stored frame-major.

#include "common.cuh"

namespace vst {
namespace {

struct TABwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int frames, n, heads, head_dim, pairs, ds;
  long long q_sf, q_sn, q_sh;
  long long k_sf, k_sn, k_sh;
  long long v_sf, v_sn, v_sh;
  float scale;
};

// out row (VEC elements at `dst`) = sum_j coef[j] * rows[j] over F rows of
// `src` (row stride d), for one 16-byte vector
template <typename T, int MAXF>
__device__ __forceinline__ void combine16(T* dst, const T* src, int d, int F,
                                          const float* coef) {
  constexpr int VEC = Vec<T>::N;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int j = 0; j < MAXF; ++j) {
    if (j < F) {
      float xf[VEC];
      unpack16<T>(src + j * d, xf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(coef[j], xf[e], acc[e]);
    }
  }
  pack16<T>(dst, acc);
}

template <typename T, int MAXF>
__global__ void ta_bwd_kernel(const TABwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = Vec<T>::N;
  const int F = a.frames, d = a.head_dim, nvec = d / VEC;
  const int pairs = a.pairs, DS = a.ds;
  const int rowlen = F * d;
  T* Qs = reinterpret_cast<T*>(smem);  // [pairs][F][d] each
  T* Ks = Qs + pairs * rowlen;         // later dv
  T* Vs = Ks + pairs * rowlen;         // later dk
  T* Ds = Vs + pairs * rowlen;         // dO
  T* Xs = Ds + pairs * rowlen;         // dq
  float* Wm = reinterpret_cast<float*>(Xs + pairs * rowlen);  // [pairs][F][F]
  float* Sm = Wm + pairs * F * F;                             // ds
  const long long total = (long long)a.n * a.heads;
  const long long pair0 = (long long)blockIdx.x * pairs;
  const int tid = threadIdx.x;

  // loads, frame-major: consecutive threads -> consecutive pairs' rows
  const int per_f = pairs * nvec;
  for (int i = tid; i < F * per_f; i += blockDim.x) {
    const int f = i / per_f, rem = i - f * per_f;
    const int p = rem / nvec, cv = rem - p * nvec;
    const long long gp = pair0 + p;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), kv = qv, vv = qv, dv = qv;
    if (gp < total) {
      const long long n = gp / a.heads, h = gp - (gp / a.heads) * a.heads;
      const long long off = (long long)cv * VEC;
      qv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.q) + f * a.q_sf + n * a.q_sn + h * a.q_sh + off));
      kv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.k) + f * a.k_sf + n * a.k_sn + h * a.k_sh + off));
      vv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.v) + f * a.v_sf + n * a.v_sn + h * a.v_sh + off));
      dv = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const T*>(a.dout) + ((long long)f * total + gp) * d + off));
    }
    const int s_off = p * rowlen + f * d + cv * VEC;
    *reinterpret_cast<uint4*>(Qs + s_off) = qv;
    *reinterpret_cast<uint4*>(Ks + s_off) = kv;
    *reinterpret_cast<uint4*>(Vs + s_off) = vv;
    *reinterpret_cast<uint4*>(Ds + s_off) = dv;
  }
  __syncthreads();

  // thread -> (pair pl, frame row r, share s); threads past the last pair
  // compute on nothing but take part in the shuffles and barriers
  const int pl = tid / (F * DS);
  const int rem = tid - pl * (F * DS);
  const int r = rem / DS, s = rem - (rem / DS) * DS;
  const bool active = pl < pairs;
  const int base = active ? pl * rowlen : 0;

  float lg[MAXF], dp[MAXF];
#pragma unroll
  for (int g = 0; g < MAXF; ++g) lg[g] = dp[g] = 0.f;
  if (active) {
    for (int cv = s; cv < nvec; cv += DS) {
      const int o = cv * VEC;
      float qf[VEC], df[VEC];
      unpack16<T>(Qs + base + r * d + o, qf);
      unpack16<T>(Ds + base + r * d + o, df);
#pragma unroll
      for (int g = 0; g < MAXF; ++g) {
        if (g < F) {
          float kf[VEC], vf[VEC];
          unpack16<T>(Ks + base + g * d + o, kf);
          unpack16<T>(Vs + base + g * d + o, vf);
          float ql = 0.f, dl = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            ql = fmaf(qf[e], kf[e], ql);
            dl = fmaf(df[e], vf[e], dl);
          }
          lg[g] += ql;
          dp[g] += dl;
        }
      }
    }
  }
  const float s2 = a.scale * kLog2e;
  float mx = -INFINITY;
#pragma unroll
  for (int g = 0; g < MAXF; ++g) {
    if (g < F) {
      for (int off = 1; off < DS; off <<= 1) {
        lg[g] += __shfl_xor_sync(0xffffffffu, lg[g], off);
        dp[g] += __shfl_xor_sync(0xffffffffu, dp[g], off);
      }
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
  float delta = 0.f;
#pragma unroll
  for (int g = 0; g < MAXF; ++g) {
    if (g < F) {
      lg[g] *= inv;  // w[r][g]
      delta = fmaf(lg[g], dp[g], delta);
    }
  }
#pragma unroll
  for (int g = 0; g < MAXF; ++g)
    if (g < F) dp[g] = lg[g] * (dp[g] - delta) * a.scale;  // ds[r][g]
  if (active && s == 0) {
    float* wrow = Wm + (pl * F + r) * F;
    float* srow = Sm + (pl * F + r) * F;
#pragma unroll
    for (int g = 0; g < MAXF; ++g) {
      if (g < F) {
        wrow[g] = lg[g];
        srow[g] = dp[g];
      }
    }
  }
  __syncthreads();  // w, ds visible; V no longer read

  if (active) {
    // dq_r = sum_g ds[r][g] k_g  -> Xs;  dk_r = sum_f ds[f][r] q_f -> Vs
    float col[MAXF];
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      col[f] = f < F ? Sm[(pl * F + f) * F + r] : 0.f;
    for (int cv = s; cv < nvec; cv += DS) {
      const int o = r * d + cv * VEC;
      combine16<T, MAXF>(Xs + base + o, Ks + base + cv * VEC, d, F, dp);
      combine16<T, MAXF>(Vs + base + o, Qs + base + cv * VEC, d, F, col);
    }
  }
  __syncthreads();  // K no longer read

  if (active) {
    // dv_r = sum_f w[f][r] do_f -> Ks
    float col[MAXF];
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      col[f] = f < F ? Wm[(pl * F + f) * F + r] : 0.f;
    for (int cv = s; cv < nvec; cv += DS)
      combine16<T, MAXF>(Ks + base + r * d + cv * VEC, Ds + base + cv * VEC,
                         d, F, col);
  }
  __syncthreads();

  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dvo = static_cast<T*>(a.dv);
  for (int i = tid; i < F * per_f; i += blockDim.x) {
    const int f = i / per_f, rm = i - f * per_f;
    const int p = rm / nvec, cv = rm - p * nvec;
    const long long gp = pair0 + p;
    if (gp >= total) continue;
    const long long go = ((long long)f * total + gp) * d + cv * VEC;
    const int s_off = p * rowlen + f * d + cv * VEC;
    *reinterpret_cast<uint4*>(dq + go) =
        *reinterpret_cast<const uint4*>(Xs + s_off);
    *reinterpret_cast<uint4*>(dk + go) =
        *reinterpret_cast<const uint4*>(Vs + s_off);
    *reinterpret_cast<uint4*>(dvo + go) =
        *reinterpret_cast<const uint4*>(Ks + s_off);
  }
}

template <typename T, int MAXF>
int launch(TABwdArgs a, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const int nvec = a.head_dim / VEC;
  a.ds = nvec % 4 == 0 ? 4 : (nvec % 2 == 0 ? 2 : 1);
  const int rows = a.frames * a.ds;  // threads per pair
  const size_t per_pair = 5 * (size_t)a.frames * a.head_dim * sizeof(T) +
                          2 * (size_t)a.frames * a.frames * sizeof(float);
  if (per_pair > 232448) return -4;
  // up to 256 threads and ~96 KB of shared memory per block
  int pairs = (int)((96 * 1024) / per_pair);
  if (pairs > 256 / rows) pairs = 256 / rows;
  if (pairs < 1) pairs = 1;
  a.pairs = pairs;
  const size_t smem = per_pair * pairs;
  auto kern = ta_bwd_kernel<T, MAXF>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (pairs * rows + 31) / 32 * 32;
  const long long total = (long long)a.n * a.heads;
  const long long blocks = (total + pairs - 1) / pairs;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_f(const TABwdArgs& a, cudaStream_t s) {
  if (a.frames <= 8) return launch<T, 8>(a, s);
  if (a.frames <= 16) return launch<T, 16>(a, s);
  if (a.frames <= 32) return launch<T, 32>(a, s);
  return -2;
}

}  // namespace
}  // namespace vst

extern "C" int vst_temporal_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, int frames, int n, int heads,
    int head_dim, long long q_sf, long long q_sn, long long q_sh,
    long long k_sf, long long k_sn, long long k_sh, long long v_sf,
    long long v_sn, long long v_sh, float scale, void* stream) {
  vst::TABwdArgs a{q,    k,    v,    dout, dq,   dk,   dv,   frames,
                   n,    heads, head_dim, 0,  0,    q_sf, q_sn, q_sh,
                   k_sf, k_sn, k_sh, v_sf, v_sn, v_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == vst::kFloat32) return vst::dispatch_f<float>(a, s);
  if (dtype == vst::kBFloat16) return vst::dispatch_f<vst::bf16>(a, s);
  return -1;
}
