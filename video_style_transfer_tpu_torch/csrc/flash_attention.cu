// K1: flash-attention forward, shared-memory route: fp32 at head dims
// 128 to 448, on no path of the port (the UNet's d = 64 attention runs
// bf16 on the wgmma route and fp32 on the 3xTF32 route of
// flash_attention_tf32.cu; the VAE's fp32 attention is d = 512, on
// flash_attention_f32.cu). bf16 runs on the wgmma routes
// (flash_attention_sm90.cu: d <= 256, flash_attention_wide.cu: d >= 320).
// This file also holds the kv-split combine that the FMA and the wide
// wgmma routes share, and the C entry point, which sends each call to its
// route.
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_attn_kernel_packed_single` / `_attn_kernel_packed` (launched by
// `_flash_fwd_bs_hd` and `_flash_fwd_qkv_packed`) and `_attn_kernel`
// (`_flash_fwd_bhsd`) for fp32 inputs at those head dims.
//
// Computes, per (batch, head), out = softmax(q k^T * scale) v and the
// natural-log log-sum-exp of each query row, reading q, k and v as
// (B, S, H, D) strided views (so the fused (B, S, 3*H*D) projection is
// read in place) and writing out (B, S, H*D) and lse (B, H, S) in f32.
//
// Bound on the H100: at d >= 128 and S >= 4096 the two products are far
// above the card's ~295 flop/byte ridge: the kernel is bound by FP32 FMA
// throughput (exact fp32, no TF32).
//
// Design: one block of 4 warps owns 32 or 64 query rows of one (batch,
// head) and walks the key/value sequence in tiles held in shared memory:
// online softmax with f32 logits, a running max and denominator per row,
// the kv tail masked. S, P and the f32 O accumulator live in shared
// memory: large d takes smaller tiles and > 48 KB of dynamic shared
// memory, K and V share one buffer (V loads while the softmax runs). The
// products are register-blocked FMA loops, so fp32 stays exact (no TF32).

#include <cstddef>

#include "common.cuh"
#include "flash_attention.cuh"

namespace vst {
namespace {

constexpr int kThreads = 128;

template <int D>
struct FlashCfg {
  static constexpr int BR = D <= 128 ? 64 : 32;
  static constexpr int BC = D <= 256 ? 64 : 32;
  static constexpr int LDQ = D + 4;  // floats, one 16 B pad per row
  static constexpr int LDK = D + 4;
  static constexpr int LDS = BC + 4;
  static constexpr int LDP = BC + 4;
  static constexpr int LDO = D + 4;
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_KV = align128(OFF_Q + sizeof(float) * BR * LDQ);
  static constexpr size_t OFF_S = align128(OFF_KV + sizeof(float) * BC * LDK);
  static constexpr size_t OFF_P = align128(OFF_S + sizeof(float) * BR * LDS);
  static constexpr size_t OFF_O = align128(OFF_P + sizeof(float) * BR * LDP);
  static constexpr size_t SMEM = align128(OFF_O + sizeof(float) * BR * LDO);
  static_assert(SMEM <= 232448, "flash tile exceeds shared memory");
  static_assert(BR % 16 == 0 && BC % 16 == 0 && D % 16 == 0, "tile shape");
};

// rows [r0, r0+ROWS) of a (rows, D) strided matrix -> shared (ROWS, LD);
// rows at or past `nrows` are zero-filled
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int nrows) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int cv = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (long long)(r0 + r) * row_stride + cv * 4));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + cv * 4) = val;
  }
}

// S = Q K^T (unscaled), BR x BC: each thread 4 rows x 1 column, float4
// steps along d
template <int D>
__device__ __forceinline__ void qk_product(const float* Qs, const float* Ks,
                                           float* Ss) {
  using C = FlashCfg<D>;
  for (int idx = threadIdx.x; idx < (C::BR / 4) * C::BC; idx += kThreads) {
    const int rq = idx / C::BC, c = idx % C::BC;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = Ks + c * C::LDK;
    const float* qr = Qs + rq * 4 * C::LDQ;
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qr + i * C::LDQ + d);
        acc[i] = fmaf(qv.x, kv.x, acc[i]);
        acc[i] = fmaf(qv.y, kv.y, acc[i]);
        acc[i] = fmaf(qv.z, kv.z, acc[i]);
        acc[i] = fmaf(qv.w, kv.w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) Ss[(rq * 4 + i) * C::LDS + c] = acc[i];
  }
}

// O += P V, BR x D, f32 accumulator in shared memory: each thread 4 rows
// x 4 columns
template <int D>
__device__ __forceinline__ void pv_product(const float* P, const float* V,
                                           float* Os) {
  using C = FlashCfg<D>;
  for (int idx = threadIdx.x; idx < (C::BR / 4) * (D / 4); idx += kThreads) {
    const int rq = idx / (D / 4), c4 = idx % (D / 4);
    float4 acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = *reinterpret_cast<const float4*>(
          Os + (rq * 4 + i) * C::LDO + c4 * 4);
    for (int j = 0; j < C::BC; ++j) {
      const float4 vv =
          *reinterpret_cast<const float4*>(V + j * C::LDK + c4 * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = P[(rq * 4 + i) * C::LDP + j];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Os + (rq * 4 + i) * C::LDO + c4 * 4) =
          acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
  using C = FlashCfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + C::OFF_Q);
  float* KVs = reinterpret_cast<float*>(smem + C::OFF_KV);
  float* Ss = reinterpret_cast<float*>(smem + C::OFF_S);
  float* Ps = reinterpret_cast<float*>(smem + C::OFF_P);
  float* Os = reinterpret_cast<float*>(smem + C::OFF_O);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * C::BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_tile<D, C::BR, C::LDQ>(Qs, qb, a.q_ss, q0, a.seq_q);
  for (int i = tid; i < C::BR * D; i += kThreads)
    Os[(i / D) * C::LDO + i % D] = 0.f;

  // TPR threads share one query row in the softmax phase
  constexpr int TPR = kThreads / C::BR;
  const int row = tid / TPR, part = tid % TPR;
  float m_i = -INFINITY, l_i = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int n_tiles = (a.seq_k + C::BC - 1) / C::BC;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * C::BC;
    __syncthreads();  // previous P.V finished reading P and V
    load_tile<D, C::BC, C::LDK>(KVs, kb, a.k_ss, k0, a.seq_k);
    __syncthreads();
    qk_product<D>(Qs, KVs, Ss);
    __syncthreads();
    // K is consumed: stream V into the shared tile during the softmax
    load_tile<D, C::BC, C::LDK>(KVs, vb, a.v_ss, k0, a.seq_k);

    float* srow = Ss + row * C::LDS;
    float mx = -INFINITY;
    for (int c = part; c < C::BC; c += TPR) {
      const float s = (k0 + c < a.seq_k) ? srow[c] * sl2 : -INFINITY;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_i, mx);
    const float corr = exp2f(m_i - m_new);
    float rs = 0.f;
    float* prow = Ps + row * C::LDP;
    for (int c = part; c < C::BC; c += TPR) {
      const float p = exp2f(srow[c] - m_new);
      rs += p;
      prow[c] = p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l_i = l_i * corr + rs;
    m_i = m_new;
    float* orow = Os + row * C::LDO;
    for (int c = part; c < D; c += TPR) orow[c] *= corr;
    __syncthreads();  // V loaded, P written, O rescaled
    pv_product<D>(Ps, KVs, Os);
  }
  __syncthreads();

  // per-row denominators and maxima for the epilogue
  float* row_l = Ss;
  float* row_m = Ss + C::BR;
  if (part == 0) {
    row_l[row] = (l_i == 0.f) ? 1.f : l_i;
    row_m[row] = m_i;
  }
  __syncthreads();

  constexpr int VPR = D / 4;
  float* ob = static_cast<float*>(a.o);
  const long long o_ss = (long long)a.heads * D;
  for (int i = tid; i < C::BR * VPR; i += kThreads) {
    const int r = i / VPR, cv = i - r * VPR;
    if (q0 + r >= a.seq_q) continue;
    const float inv = 1.f / row_l[r];
    float vals[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) vals[e] = Os[r * C::LDO + cv * 4 + e] * inv;
    pack16<float>(ob + ((long long)b * a.seq_q + q0 + r) * o_ss + h * D +
                      cv * 4,
                  vals);
  }
  for (int r = tid; r < C::BR; r += kThreads) {
    if (q0 + r < a.seq_q)
      a.lse[((long long)b * a.heads + h) * a.seq_q + q0 + r] =
          (row_m[r] + log2f(row_l[r])) * (1.0f / kLog2e);
  }
}

// out = sum_s exp(lse_s - lse) o_s, lse = log sum_s exp(lse_s): one block
// of D / 4 threads a (batch, head, query) row, 4 values of D each, out in
// T
template <typename T>
__global__ void __launch_bounds__(128)
    flash_combine_kernel(const FlashArgs a, int d, int splits,
                         const float* part) {
  const long long rows = (long long)a.batch * a.heads * a.seq_q;
  const long long row = blockIdx.x;  // (b, h, q)
  const float* plse = part + rows * d * splits + row;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, plse[s * rows]);
  float wsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float w = expf(plse[s * rows] - m);
    const float4 v = *reinterpret_cast<const float4*>(
        part + (s * rows + row) * d + 4 * threadIdx.x);
    wsum += w;
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
  }
  const float inv = 1.f / wsum;
  const int q = static_cast<int>(row % a.seq_q);
  const long long bh = row / a.seq_q;
  const int h = static_cast<int>(bh % a.heads);
  const long long b = bh / a.heads;
  T* o = static_cast<T*>(a.o) + (b * a.seq_q + q) * a.heads * d + h * d +
         4 * threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(o) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  } else {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_bf16x2(acc.x * inv, acc.y * inv),
                   pack_bf16x2(acc.z * inv, acc.w * inv));
  }
  if (threadIdx.x == 0) a.lse[row] = m + logf(wsum);
}

// --------------------------------------------------------------- launch

template <int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using C = FlashCfg<D>;
  auto kern = flash_fwd_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.seq_q + C::BR - 1) / C::BR, a.heads, a.batch);
  kern<<<grid, kThreads, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// fp32 from 128 to 448 (64: the 3xTF32 route; 512: the FMA route)
int dispatch_f32(int d, const FlashArgs& a, cudaStream_t s) {
  switch (d) {
    case 64: return flash_fwd_tf32(a, s);
    case 128: return launch<128>(a, s);
    case 192: return launch<192>(a, s);
    case 256: return launch<256>(a, s);
    case 320: return launch<320>(a, s);
    case 384: return launch<384>(a, s);
    case 448: return launch<448>(a, s);
    default: return -2;
  }
}

// One K1 call on the current device, by route; the routes that split the
// kv walk (fp32 d = 512, bf16 d >= 320) merge their splits after.
int flash_fwd(const FwdCall& c) {
  FlashArgs a{c.q,    c.k,    c.v,    c.o,    static_cast<float*>(c.lse),
              c.batch, c.seq_q, c.seq_k, c.heads, c.q_sb, c.q_ss, c.q_sh,
              c.k_sb, c.k_ss, c.k_sh, c.v_sb, c.v_ss, c.v_sh, c.scale};
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  const int d = c.head_dim;
  float* part = static_cast<float*>(c.part);
  int err;
  if (c.dtype == kFloat32 && d == 512) {
    err = flash_fwd_f32(a, c.kv_splits, part, s);
  } else if (c.dtype == kBFloat16 && d >= 320) {
    err = flash_fwd_sm90_wide(d, a, c.kv_splits, part, s);
  } else {
    if (c.kv_splits != 1) return -2;  // the other routes do not split
    if (c.dtype == kFloat32) return dispatch_f32(d, a, s);
    if (c.dtype == kBFloat16) return flash_fwd_sm90(d, a, s);
    return -1;
  }
  if (err != 0 || c.kv_splits == 1) return err;
  return flash_combine(a, c.dtype, d, c.kv_splits, part, s);
}

}  // namespace

int flash_combine(const FlashArgs& a, int dtype, int head_dim, int splits,
                  const float* part, cudaStream_t stream) {
  if (head_dim % 4 != 0 || head_dim / 4 > 128 || splits < 2) return -2;
  const long long rows = (long long)a.batch * a.heads * a.seq_q;
  if (rows > 0x7fffffff) return -2;
  if (dtype == kFloat32)
    flash_combine_kernel<float><<<(unsigned)rows, head_dim / 4, 0, stream>>>(
        a, head_dim, splits, part);
  else if (dtype == kBFloat16)
    flash_combine_kernel<bf16><<<(unsigned)rows, head_dim / 4, 0, stream>>>(
        a, head_dim, splits, part);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace vst

static_assert(offsetof(vst::FwdCall, scale) == 160,
              "FwdCall must match ops/flash_attention.py's packing");

// One K1 call from its packed arguments: launched on the call's device,
// made current for the launch where another one is.
extern "C" int vst_flash_attention_fwd(const vst::FwdCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::flash_fwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::flash_fwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
