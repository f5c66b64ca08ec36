// K1: flash-attention forward, shared-memory route: fp32 at head dims 64
// to 448 and bf16 at d = 320 ... 512 (the VAE under --vae_dtype bfloat16).
// fp32 at d = 512 (the VAE's mid-block attention) runs on
// flash_attention_f32.cu and bf16 at d <= 256 (every UNet attention, and
// K6's d = 192) on flash_attention_sm90.cu; the C entry point below sends
// each call to its route.
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_attn_kernel_packed_single` / `_attn_kernel_packed` (launched by
// `_flash_fwd_bs_hd` and `_flash_fwd_qkv_packed`).
//
// Computes, per (batch, head), out = softmax(q k^T * scale) v and the
// natural-log log-sum-exp of each query row, reading q, k and v as
// (B, S, H, D) strided views (so the fused (B, S, 3*H*D) projection is
// read in place) and writing out (B, S, H*D) and lse (B, H, S) in f32.
//
// Bound on the H100: at d >= 320 and S >= 4096 the two products are far
// above the card's ~295 flop/byte ridge: the kernel is bound by FP32 FMA
// throughput (fp32, no TF32) or tensor-core throughput (bf16).
//
// Design: one block of 4 warps owns 32 query rows of one (batch, head)
// and walks the key/value sequence in tiles held in shared memory: online
// softmax with f32 logits, a running max and denominator per row, the kv
// tail masked. S, P and the f32 O accumulator live in shared memory,
// which is what lets d = 512 fit (a 32x512 f32 tile is 64 KB): large d
// takes smaller tiles and > 48 KB of dynamic shared memory, K and V share
// one buffer (V loads while the softmax runs). bf16 uses WMMA 16x16x16;
// fp32 register-blocked FMA loops, so fp32 stays exact (no TF32).

#include <mma.h>

#include <cstddef>

#include "common.cuh"
#include "flash_attention.cuh"

namespace vst {
namespace {

constexpr int kThreads = 128;

template <typename T, int D>
struct FlashCfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int BR = (!kBf16 && D <= 128) ? 64 : 32;
  static constexpr int BC = kBf16 ? 64 : (D <= 256 ? 64 : 32);
  static constexpr int VEC = Vec<T>::N;
  static constexpr int LDQ = D + VEC;  // T elements, one 16 B pad per row
  static constexpr int LDK = D + VEC;
  static constexpr int LDS = BC + 4;   // floats
  static constexpr int LDP = BC + VEC; // T elements
  static constexpr int LDO = D + 4;    // floats
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_KV = align128(OFF_Q + sizeof(T) * BR * LDQ);
  static constexpr size_t OFF_S = align128(OFF_KV + sizeof(T) * BC * LDK);
  static constexpr size_t OFF_P = align128(OFF_S + sizeof(float) * BR * LDS);
  static constexpr size_t OFF_O = align128(OFF_P + sizeof(T) * BR * LDP);
  static constexpr size_t SMEM = align128(OFF_O + sizeof(float) * BR * LDO);
  static_assert(SMEM <= 232448, "flash tile exceeds shared memory");
  static_assert(BR % 16 == 0 && BC % 16 == 0 && D % 16 == 0, "tile shape");
};

// rows [r0, r0+ROWS) of a (rows, D) strided matrix -> shared (ROWS, LD);
// rows at or past `nrows` are zero-filled
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int r0,
                                          int nrows) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int cv = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (long long)(r0 + r) * row_stride + cv * VEC));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + cv * VEC) = val;
  }
}

// S = Q K^T (unscaled), BR x BC, f32
template <typename T, int D>
__device__ __forceinline__ void qk_product(const T* Qs, const T* Ks,
                                           float* Ss) {
  using C = FlashCfg<T, D>;
  if constexpr (C::kBf16) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    constexpr int RT = C::BR / 16, CT = C::BC / 16;
    for (int tile = warp; tile < RT * CT; tile += kThreads / 32) {
      const int rb = tile / CT, cb = tile % CT;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + rb * 16 * C::LDQ + kk * 16, C::LDQ);
        wmma::load_matrix_sync(fb, Ks + cb * 16 * C::LDK + kk * 16, C::LDK);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + rb * 16 * C::LDS + cb * 16, acc, C::LDS,
                              wmma::mem_row_major);
    }
  } else {
    // each thread: 4 rows x 1 column, float4 steps along d
    for (int idx = threadIdx.x; idx < (C::BR / 4) * C::BC; idx += kThreads) {
      const int rq = idx / C::BC, c = idx % C::BC;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = reinterpret_cast<const float*>(Ks) + c * C::LDK;
      const float* qr = reinterpret_cast<const float*>(Qs) + rq * 4 * C::LDQ;
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
}

// O += P V, BR x D, f32 accumulator in shared memory
template <typename T, int D>
__device__ __forceinline__ void pv_product(const T* Ps, const T* Vs,
                                           float* Os) {
  using C = FlashCfg<T, D>;
  if constexpr (C::kBf16) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    constexpr int RT = C::BR / 16, DT = D / 16;
    for (int tile = warp; tile < RT * DT; tile += kThreads / 32) {
      const int rb = tile / DT, cb = tile % DT;
      float* optr = Os + rb * 16 * C::LDO + cb * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, optr, C::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < C::BC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + rb * 16 * C::LDP + kk * 16, C::LDP);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * C::LDK + cb * 16, C::LDK);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, C::LDO, wmma::mem_row_major);
    }
  } else {
    // each thread: 4 rows x 4 columns
    const float* P = reinterpret_cast<const float*>(Ps);
    const float* V = reinterpret_cast<const float*>(Vs);
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
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
  using C = FlashCfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + C::OFF_Q);
  T* KVs = reinterpret_cast<T*>(smem + C::OFF_KV);
  float* Ss = reinterpret_cast<float*>(smem + C::OFF_S);
  T* Ps = reinterpret_cast<T*>(smem + C::OFF_P);
  float* Os = reinterpret_cast<float*>(smem + C::OFF_O);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * C::BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_tile<T, D, C::BR, C::LDQ>(Qs, qb, a.q_ss, q0, a.seq_q);
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
    load_tile<T, D, C::BC, C::LDK>(KVs, kb, a.k_ss, k0, a.seq_k);
    __syncthreads();
    qk_product<T, D>(Qs, KVs, Ss);
    __syncthreads();
    // K is consumed: stream V into the shared tile during the softmax
    load_tile<T, D, C::BC, C::LDK>(KVs, vb, a.v_ss, k0, a.seq_k);

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
    T* prow = Ps + row * C::LDP;
    for (int c = part; c < C::BC; c += TPR) {
      const float p = exp2f(srow[c] - m_new);
      rs += p;
      prow[c] = from_f<T>(p);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l_i = l_i * corr + rs;
    m_i = m_new;
    float* orow = Os + row * C::LDO;
    for (int c = part; c < D; c += TPR) orow[c] *= corr;
    __syncthreads();  // V loaded, P written, O rescaled
    pv_product<T, D>(Ps, KVs, Os);
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

  constexpr int VEC = C::VEC;
  constexpr int VPR = D / VEC;
  T* ob = static_cast<T*>(a.o);
  const long long o_ss = (long long)a.heads * D;
  for (int i = tid; i < C::BR * VPR; i += kThreads) {
    const int r = i / VPR, cv = i - r * VPR;
    if (q0 + r >= a.seq_q) continue;
    const float inv = 1.f / row_l[r];
    float vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) vals[e] = Os[r * C::LDO + cv * VEC + e] * inv;
    pack16<T>(ob + ((long long)b * a.seq_q + q0 + r) * o_ss + h * D + cv * VEC,
              vals);
  }
  for (int r = tid; r < C::BR; r += kThreads) {
    if (q0 + r < a.seq_q)
      a.lse[((long long)b * a.heads + h) * a.seq_q + q0 + r] =
          (row_m[r] + log2f(row_l[r])) * (1.0f / kLog2e);
  }
}

// --------------------------------------------------------------- launch

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using C = FlashCfg<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.seq_q + C::BR - 1) / C::BR, a.heads, a.batch);
  kern<<<grid, kThreads, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// fp32 up to 448 (512: the FMA route), bf16 from 320 up (below, the
// wgmma route)
template <typename T>
int dispatch_d(int d, const FlashArgs& a, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 64: return launch<T, 64>(a, s);
      case 128: return launch<T, 128>(a, s);
      case 192: return launch<T, 192>(a, s);
      case 256: return launch<T, 256>(a, s);
      case 320: return launch<T, 320>(a, s);
      case 384: return launch<T, 384>(a, s);
      case 448: return launch<T, 448>(a, s);
      default: return -2;
    }
  } else {
    switch (d) {
      case 320: return launch<T, 320>(a, s);
      case 384: return launch<T, 384>(a, s);
      case 448: return launch<T, 448>(a, s);
      case 512: return launch<T, 512>(a, s);
      default: return -2;
    }
  }
}

// One K1 call on the current device, by route.
int flash_fwd(const FwdCall& c) {
  FlashArgs a{c.q,    c.k,    c.v,    c.o,    static_cast<float*>(c.lse),
              c.batch, c.seq_q, c.seq_k, c.heads, c.q_sb, c.q_ss, c.q_sh,
              c.k_sb, c.k_ss, c.k_sh, c.v_sb, c.v_ss, c.v_sh, c.scale};
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  const int d = c.head_dim;
  if (c.dtype == kFloat32 && d == 512)
    return flash_fwd_f32(a, c.kv_splits, static_cast<float*>(c.part), s);
  if (c.kv_splits != 1) return -2;  // only the FMA route splits the kv walk
  if (c.dtype == kFloat32) return dispatch_d<float>(d, a, s);
  if (c.dtype == kBFloat16 && d <= 256) return flash_fwd_sm90(d, a, s);
  if (c.dtype == kBFloat16) return dispatch_d<bf16>(d, a, s);
  return -1;
}

}  // namespace
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
