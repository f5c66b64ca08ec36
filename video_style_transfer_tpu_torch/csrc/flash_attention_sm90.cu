// K1 (bf16, head_dim 64 / 128 / 192 / 256): flash-attention forward on
// Hopper's warpgroup products and tensor memory accelerator.
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_attn_kernel_packed_single` / `_attn_kernel_packed` (packed heads,
// d = 64) and `_attn_kernel` (K6, the unpacked kernel of head dims the TPU
// cannot pack, such as d = 192), for bf16 inputs. fp32 and bf16 d >= 320
// stay on flash_attention.cu's shared-memory kernel.
//
// Same function as that kernel: per (batch, head), out = softmax(q k^T *
// scale) v with f32 logits, running max and sum, P rounded to bf16 for
// the P.V product and O once at the output; lse in natural-log units. q,
// k and v are read as (B, S, H, D) strided views (the fused (B, S,
// 3*H*D) projection in place); out is (B, Sq, H*D), lse (B, H, Sq) f32.
//
// Bound on the H100: ~4 * Sq * Sk * D flops against ~4 * S * D * 2 bytes
// a head, so at the UNet's S >= 1024 tensor-core throughput bounds it.
// The design is for that:
//
// - Both products run on wgmma, the only way to the card's full bf16
//   rate. S = Q K^T is m64nBCk16 with Q and K read from shared memory
//   (both K-major). O += P V is m64nDk16 with P taken from registers (the
//   f32 accumulator of S, exponentiated and packed to bf16, is already in
//   the A-fragment layout) and V read from shared memory as an MN-major
//   operand through the product's transpose bit. O stays in registers for
//   the whole kv walk; the softmax runs on the accumulator fragments (a
//   row's values sit in one quad of lanes: two shuffles).
// - TMA loads every tile: 4-D tensor maps (D, H, S, B) built from the
//   views' strides, 128-byte swizzled to match the descriptors, 64 values
//   of D per box. Rows past S are zero-filled by the hardware (the kv tail
//   is also masked to -inf).
// - Warp specialisation: warpgroup 0 is the producer (one thread issues
//   Q once, then K and V into a ring of NST stages, each completed on its
//   own mbarrier, K apart from V so that Q K^T starts before V lands) and
//   gives its registers to the two consumer warpgroups (setmaxnreg: 40
//   and 232 a thread), each of which owns 64 query rows. Consumers hand
//   stages back on "empty" barriers; no block-wide barrier runs inside
//   the kv loop. Within a warpgroup the two products and the softmax run
//   in turn; the two warpgroups' turns interleave on the SM.
// - Tiles by D so that registers fit: BC = 128 keys at D <= 128 (S 64
//   f32 a thread, O 32 / 64), BC = 64 at D >= 192 (S 32, O 96 / 128);
//   three ring stages, two at D = 256 (shared memory).

#include "common.cuh"
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace vst {
namespace {

using namespace sm90;

template <int D>
struct Sm90Cfg {
  static constexpr int BR = 128;  // two consumer warpgroups x 64 rows
  static constexpr int BC = D <= 128 ? 128 : 64;
  // K/V ring stages: three where shared memory holds them
  static constexpr int NST = D == 256 ? 2 : 3;
  static constexpr int THREADS = 384;
  static constexpr uint32_t Q_PANEL = BR * 128;   // bytes of one 64-wide panel
  static constexpr uint32_t KV_PANEL = BC * 128;
  static constexpr uint32_t Q_BYTES = Q_PANEL * (D / 64);
  static constexpr uint32_t KV_BYTES = KV_PANEL * (D / 64);  // K or V tile
  static constexpr size_t OFF_K = Q_BYTES;
  static constexpr size_t OFF_V = OFF_K + NST * KV_BYTES;
  static constexpr size_t OFF_BAR = OFF_V + NST * KV_BYTES;
  // barriers: Q, full K[NST], full V[NST], empty[NST]; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 3 * NST) + 1024;
  static_assert(D % 64 == 0 && D <= 256, "head dim");
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

// S (64 x BC) = Q K^T over D / 16 K steps, both K-major in shared memory
template <int D, int BC>
__device__ __forceinline__ void qk_product(float* s, uint32_t q_addr,
                                           uint32_t k_addr, uint32_t q_panel,
                                           uint32_t k_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BC>(s, desc_kmajor(q_addr, q_panel, kk),
                 desc_kmajor(k_addr, k_panel, kk), kk > 0);
}

// O (64 x D) += P V over BC / 16 K steps; P from registers, V MN-major
template <int D, int BC>
__device__ __forceinline__ void pv_product(float* o,
                                           uint32_t (&p)[BC / 16][4],
                                           uint32_t v_addr,
                                           uint32_t v_panel) {
#pragma unroll
  for (int j = 0; j < BC / 16; ++j)
    wgmma_rs_vt<D>(o, p[j], desc_mnmajor(v_addr, v_panel, j), 1);
}

// Online softmax of one S tile in place: masks keys at or past seq_k,
// updates the running max m (raw logits) and this thread's share of the
// running sum l, leaves exp2(s * scale * log2e - max) in s and the factor
// by which the old O and l shrink in corr.
template <int BC>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, int k0, int seq_k,
                                             float sl2) {
  if (k0 + BC > seq_k) {
#pragma unroll
    for (int i = 0; i < BC / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * i + 2 * (threadIdx.x % 4) + (e & 1) >= seq_k)
          s[4 * i + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BC / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float msc[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
    msc[r] = mx[r] * sl2;
  }
#pragma unroll
  for (int i = 0; i < BC / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * i + e] = ex2(fmaf(s[4 * i + e], sl2, -msc[e >> 1]));
      rs[e >> 1] += s[4 * i + e];
    }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FlashArgs a) {
  using C = Sm90Cfg<D>;
  constexpr int BC = C::BC, NST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + NST;
  uint64_t* empty = full_v + NST;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * C::BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.seq_k + BC - 1) / BC;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_load_4d(smem + p * C::Q_PANEL, &tq, bar_q, p * 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NST;
        mbar_wait(&empty[st], ((t / NST) & 1) ^ 1);
        unsigned char* ks = smem + C::OFF_K + st * C::KV_BYTES;
        unsigned char* vs = smem + C::OFF_V + st * C::KV_BYTES;
        mbar_arrive_tx(&full_k[st], C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(ks + p * C::KV_PANEL, &tk, &full_k[st], p * 64, h,
                      t * BC, b);
        mbar_arrive_tx(&full_v[st], C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(vs + p * C::KV_PANEL, &tv, &full_v[st], p * 64, h,
                      t * BC, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // this warpgroup's 64 rows start 64 rows into each Q panel
    const uint32_t q_addr = smem_u32(smem) + c * 64 * 128;
    const uint32_t k_addr = smem_u32(smem + C::OFF_K);
    const uint32_t v_addr = smem_u32(smem + C::OFF_V);
    const float sl2 = a.scale * kLog2e;

    float o[D / 2];
    float s[BC / 2];
    uint32_t p[BC / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) s[i] = 0.f;
    // rows g and g + 8 of this warp's 16: running max (raw logits) and
    // this thread's share of the running sum
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
    float corr[2];

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % NST;
      const uint32_t ph = (t / NST) & 1;
      // S = Q K^T
      mbar_wait(&full_k[st], ph);
      fence_regs<BC / 2>(s);
      wgmma_fence();
      qk_product<D, BC>(s, q_addr, k_addr + st * C::KV_BYTES, C::Q_PANEL,
                        C::KV_PANEL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<BC / 2>(s);
      softmax_tile<BC>(s, m_i, l_i, corr, t * BC, a.seq_k, sl2);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
      pack_a<BC>(p, s);
      // O += P V, then hand the stage back to the producer
      mbar_wait(&full_v[st], ph);
      fence_regs<D / 2>(o);
      fence_p<BC / 16>(p);
      wgmma_fence();
      pv_product<D, BC>(o, p, v_addr + st * C::KV_BYTES, C::KV_PANEL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // epilogue: the quad's shares of each row sum, then out and lse
    bf16* ob = static_cast<bf16*>(a.o);
    const long long o_ss = (long long)a.heads * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + c * 64 + warp * 16 + g + r * 8;
      if (row < a.seq_q) {
        l = l == 0.f ? 1.f : l;
        const float inv = __frcp_rn(l);
        bf16* orow =
            ob + ((long long)b * a.seq_q + row) * o_ss + h * D + t4 * 2;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(orow + i * 8) = pack_bf16x2(
              o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
        if (t4 == 0)
          a.lse[((long long)b * a.heads + h) * a.seq_q + row] =
              (m_i[r] * sl2 + log2f(l)) * (1.0f / kLog2e);
      }
    }
  }
}

template <int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using C = Sm90Cfg<D>;
  CUtensorMap tq, tk, tv;
  // boxes of 64 bf16 of D (one 128-byte swizzled panel) by BR or BC rows
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  int e = bshd_tensor_map(&tq, BF16, 2, a.q, a.batch, a.seq_q, a.heads, D,
                          a.q_sb, a.q_ss, a.q_sh, 64, C::BR, SW);
  if (e == 0)
    e = bshd_tensor_map(&tk, BF16, 2, a.k, a.batch, a.seq_k, a.heads, D,
                        a.k_sb, a.k_ss, a.k_sh, 64, C::BC, SW);
  if (e == 0)
    e = bshd_tensor_map(&tv, BF16, 2, a.v, a.batch, a.seq_k, a.heads, D,
                        a.v_sb, a.v_ss, a.v_sh, 64, C::BC, SW);
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  auto kern = flash_fwd_sm90_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.seq_q + C::BR - 1) / C::BR, a.heads, a.batch);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_fwd_sm90(int head_dim, const FlashArgs& a, cudaStream_t stream) {
  if (a.seq_k < 1) return -2;
  switch (head_dim) {
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    case 192: return launch<192>(a, stream);
    case 256: return launch<256>(a, stream);
    default: return -2;
  }
}

}  // namespace vst
