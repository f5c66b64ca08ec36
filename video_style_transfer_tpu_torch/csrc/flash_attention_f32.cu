// K1 (fp32, head_dim 128 to 512): flash-attention forward on Hopper's
// FP32 FMA pipes: the VAE's mid-block attention (one head, d = 512, 16384
// tokens at 1024^2, 4096 at 512^2) and every other fp32 head dim but 64
// (128, 192, 256, 320, 384, 448: on no path of the port; JAX takes them).
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_attn_kernel_packed` (launched by `_flash_fwd_bs_hd`, one head a block
// at d = 512), `_attn_kernel_packed_single` and, at head dims the TPU
// cannot pack (192, 320, 448), `_attn_kernel` (`_flash_fwd_bhsd`) for fp32
// inputs. fp32 d = 64 runs on flash_attention_tf32.cu's 3xTF32 route;
// bf16 on flash_attention_sm90.cu (d <= 256) and flash_attention_wide.cu
// (d >= 320).
//
// Same function: per (batch, head), out = softmax(q k^T * scale) v with
// f32 logits, running max and sum, exact fp32 throughout (no TF32), and
// lse in natural-log units. q, k and v are read as (B, S, H, D) strided
// views (the fused (B, S, 3*H*D) projection in place); out is (B, Sq,
// H*D), lse (B, H, Sq) f32; the kv tail is masked, q-tail rows are not
// written.
//
// Bound on the H100: 4 * Sq * Sk * D flops against 4 * S * D * 4 bytes a
// head, so at S >= 4096 the card's FP32 FMA rate (67 TF/s, 128 FMA a clock
// per SM) bounds it. Two things stand in its way: every instruction that
// is not an FMA takes a dispatch slot from one, and shared memory serves
// 128 bytes of lane data a clock per SM (a float4 load takes 4 clocks,
// broadcast or not), so each lane must load at most one byte per FMA. The
// design, one template on D (`FmaCfg`; ops/flash_attention.py:fma_tiles
// mirrors its choices):
//
// - Register micro-tiles. A block of 8 warps owns 64 query rows and walks
//   the keys in tiles of BC = 256. A thread computes 8 rows x 8 keys of S
//   = Q K^T (per d: 8 q and 8 k values, 64 FMAs: 4 FMAs a float, whatever
//   D) and 8 rows x D/32 columns of O += P V (per kv row: 8 p and D/32 v
//   values), the same 8 rows in both. A warp is 4 row groups x 8 key (or
//   column) groups and the 8 warps are 2 row halves x 4 quarters of the
//   keys (or columns); a thread's O columns in a quarter are float4s
//   where a quarter holds 8 lanes' float4s evenly (D % 128 == 0), else
//   float2s, so every load is free of bank conflicts. P V reaches 4 FMAs a
//   float from D = 256 up; below that its loads, not its FMAs, bound it
//   (8 p values for 4 or 6 columns), which no layout of 64 rows over 256
//   threads avoids.
// - O in registers (8 x D/32 floats a thread) for the whole kv walk; the
//   online-softmax correction is applied there. The row max and sum of a
//   tile are reduced over the 8 lanes of a row group by shuffles and over
//   the 4 quarters through shared memory. P (256 keys x 64 rows) goes to
//   shared memory, 16-byte units swizzled so that stores and loads hit
//   distinct banks.
// - Q is loaded once, transposed (Qt[d][row], D x 64 floats), so that one
//   float4 holds 4 rows at one d. TMA streams K in chunks of 256 keys x 16
//   d (its 64-byte swizzle lets 8 consecutive keys' float2 reads hit
//   distinct banks) and V in chunks of VR rows x D (the most rows, a power
//   of two, whose D columns fit a K chunk's 16 KB: 32 at d = 128, 16 at
//   192 and 256, 8 from 320 up; one box of D columns up to 256, two of D/2
//   above), through a ring of two 16 KB stages on mbarriers: every chunk
//   loads while the one before it is computed, so K's loads, V's loads
//   and the softmax all overlap a product, and no thread spends a dispatch
//   slot on a copy (TMA cannot transpose fp32, hence K's natural layout).
//   One block-wide barrier per chunk frees its stage. Shared memory: Qt (D
//   x 256 bytes) + P 64 KB + stages 32 KB + row statistics; 227 KB at d =
//   512.
// - 256 threads at up to 255 registers each: one block (8 warps) per SM.
//   Where a grid would leave SMs idle (one head at S = 4096: 64 blocks)
//   the wrapper splits the kv walk (`kv_splits`) and flash_attention.cu's
//   combine kernel merges the partial outputs by their lse.

#include "common.cuh"
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace vst {
namespace {

using namespace sm90;

constexpr int BR = 64;          // query rows a block
constexpr int BC = 256;         // keys a kv tile
constexpr int THREADS = 256;    // 8 warps
constexpr int DK = 16;          // d columns of a K chunk
constexpr int NST = 2;          // stages in the ring
constexpr int STAGE = BC * DK;  // floats: a K chunk; a V chunk fits in it
static_assert(DK == 16, "K boxes of 16 d (64-byte rows)");

template <int D>
struct FmaCfg {
  // kv rows of a V chunk, columns of a V box, O columns a thread updates
  // from one load (a float4 or a float2), O columns a thread
  static constexpr int VR = D <= 128 ? 32 : D <= 256 ? 16 : 8;
  static constexpr int V_BOX = D <= 256 ? D : D / 2;
  static constexpr int VW = D % 128 == 0 ? 4 : 2;
  static constexpr int OC = D / 32;
  static constexpr int K_CHUNKS = D / DK;
  static constexpr int V_CHUNKS = BC / VR;
  static constexpr int CHUNKS = K_CHUNKS + V_CHUNKS;
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_P = OFF_Q + sizeof(float) * D * BR;
  static constexpr size_t OFF_ST = OFF_P + sizeof(float) * BC * BR;
  static constexpr size_t OFF_STAT = OFF_ST + sizeof(float) * STAGE * NST;
  // row max and sum, then each quarter's partial max and sum of a tile
  static constexpr size_t OFF_BAR =
      OFF_STAT + sizeof(float) * (2 + 2 * 4) * BR;
  static constexpr size_t SMEM = OFF_BAR + sizeof(uint64_t) * NST;
  static_assert(D % 64 == 0 && D >= 128 && D <= 512, "head dims 128-512");
  static_assert(VR * D <= STAGE && BC % VR == 0, "a V chunk fits a stage");
  static_assert(V_BOX <= 256 && V_BOX % (D / 4) == 0,
                "V boxes of at most 256 columns, each quarter in one box");
  static_assert(OC % VW == 0, "whole vectors of O columns");
  static_assert(OFF_ST % 1024 == 0 && STAGE * 4 % 1024 == 0 &&
                    VR * V_BOX * 4 % 128 == 0,
                "TMA boxes start on 1024-byte (K) and 128-byte (V) "
                "boundaries");
  static_assert(SMEM <= 232448, "fp32 flash tile exceeds shared memory");
};

// Offset (floats) of K[key][2m..2m+1] in a K chunk: a box of 256 keys x
// 16 d as TMA's 64-byte swizzle lays it, a row's 16-byte units permuted
// by (key >> 1) & 3, so that 8 consecutive keys' float2 m hit distinct
// banks.
__device__ __forceinline__ int k_off(int key, int m) {
  return key * DK + (((m >> 1) ^ ((key >> 1) & 3)) << 2) + ((m & 1) << 1);
}

// Offset (floats) of V[row][col] in a V chunk: boxes of VR rows x V_BOX.
template <int D>
__device__ __forceinline__ int v_off(int row, int col) {
  using C = FmaCfg<D>;
  return (col / C::V_BOX) * (C::VR * C::V_BOX) + row * C::V_BOX +
         col % C::V_BOX;
}

// Offset (floats) of P[key][row..row+3] (row a multiple of 4): rows of 64
// whose 16-byte units are permuted by key & 7, so that the 8 key groups of
// a warp's stores hit distinct banks.
__device__ __forceinline__ int p_off(int key, int row) {
  return key * BR + (((row >> 2) ^ (key & 7)) << 2);
}

// VW floats of shared memory at p into v
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const SplitArgs args) {
  using C = FmaCfg<D>;
  constexpr int VR = C::VR, VW = C::VW, OC = C::OC;
  constexpr int K_CHUNKS = C::K_CHUNKS, V_CHUNKS = C::V_CHUNKS;
  constexpr int CHUNKS = C::CHUNKS;
  const FlashArgs& a = args.a;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qt = reinterpret_cast<float*>(smem + C::OFF_Q);
  float* Ps = reinterpret_cast<float*>(smem + C::OFF_P);
  float* St = reinterpret_cast<float*>(smem + C::OFF_ST);
  float* row_m = reinterpret_cast<float*>(smem + C::OFF_STAT);
  float* row_l = row_m + BR;
  float* part_m = row_l + BR;        // [quarter][row]
  float* part_l = part_m + 4 * BR;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // this thread: rows r0..r0+7; key / column quarter qt, group kg
  const int qt = warp & 3, kg = lane & 7;
  const int r0 = (warp >> 2) * 32 + (lane >> 3) * 8;
  const int q0 = blockIdx.x * BR;
  const int split = blockIdx.y % args.kv_splits;
  const int h = blockIdx.y / args.kv_splits;
  const int b = blockIdx.z;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const int kv0 = split * args.tiles_per_split * BC;
  const int kv_end = min(a.seq_k, kv0 + args.tiles_per_split * BC);
  const int n_tiles = (kv_end - kv0 + BC - 1) / BC;
  const int n_chunks = n_tiles * CHUNKS;

  // chunk g of the kv walk into stage g % NST, by TMA from one thread:
  // tile g / CHUNKS, then either the K chunk of d columns [DK c, DK c +
  // DK) or the V chunk of rows [VR c', VR c' + VR); rows past Sk arrive
  // as zeros
  auto load_chunk = [&](int g) {
    float* st = St + (g % NST) * STAGE;
    uint64_t* bar = &full[g % NST];
    const int k0 = kv0 + (g / CHUNKS) * BC;
    const int c = g % CHUNKS;
    if (c < K_CHUNKS) {
      mbar_arrive_tx(bar, STAGE * sizeof(float));
      tma_load_4d(st, &tk, bar, c * DK, h, k0, b);
    } else {
      mbar_arrive_tx(bar, VR * D * sizeof(float));
#pragma unroll
      for (int i = 0; i < D / C::V_BOX; ++i)
        tma_load_4d(st + i * VR * C::V_BOX, &tv, bar, i * C::V_BOX, h,
                    k0 + (c - K_CHUNKS) * VR, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < NST - 1 && i < n_chunks; ++i) load_chunk(i);
  }

  // Q, transposed: lanes take 32 consecutive rows of one float4 of d
  for (int e = tid; e < BR * (D / 4); e += THREADS) {
    const int row = e & (BR - 1), d = (e >> 6) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < a.seq_q)
      v = __ldg(reinterpret_cast<const float4*>(
          qb + (long long)(q0 + row) * a.q_ss + d));
    Qt[(d + 0) * BR + row] = v.x;
    Qt[(d + 1) * BR + row] = v.y;
    Qt[(d + 2) * BR + row] = v.z;
    Qt[(d + 3) * BR + row] = v.w;
  }
  if (tid < BR) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // rows r0 + r, columns qt D/4 + 8 VW i + VW kg + e (VW j = VW i + e)
  float o[8][OC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < OC; ++j) o[r][j] = 0.f;

  const float sl2 = a.scale * kLog2e;

  // one pipeline step: every thread is past chunk g - 1, so its stage
  // takes chunk g + NST - 1; then chunk g is waited for
  int g = 0;
  auto next_stage = [&]() {
    __syncthreads();
    if (tid == 0 && g + NST - 1 < n_chunks) load_chunk(g + NST - 1);
    mbar_wait(&full[g % NST], (g / NST) & 1);
    return St + (g++ % NST) * STAGE;
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv0 + t * BC;
    // S = Q K^T: rows r0 + r, keys 64 qt + kg + 8 j
    float s[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
    for (int c = 0; c < K_CHUNKS; ++c) {
      const float* st = next_stage();
      const float* qd = Qt + c * DK * BR + r0;
#pragma unroll
      for (int m = 0; m < DK / 2; ++m) {
        float2 kv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kv[j] = *reinterpret_cast<const float2*>(
              st + k_off(64 * qt + kg + 8 * j, m));
#pragma unroll
        for (int dd = 0; dd < 2; ++dd) {
          const float4 qa =
              *reinterpret_cast<const float4*>(qd + (2 * m + dd) * BR);
          const float4 qc =
              *reinterpret_cast<const float4*>(qd + (2 * m + dd) * BR + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w,
                               qc.x, qc.y, qc.z, qc.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float k = dd == 0 ? kv[j].x : kv[j].y;
#pragma unroll
            for (int r = 0; r < 8; ++r) s[r][j] = fmaf(qv[r], k, s[r][j]);
          }
        }
      }
    }

    // online softmax while the first V chunk loads: each quarter's max
    // and sum over its 64 keys (8 lanes, shuffles), then over the four
    // quarters through shared memory
    float m_new[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[r][j] = k0 + 64 * qt + kg + 8 * j < kv_end ? s[r][j] * sl2
                                                      : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      m_new[r] = mx;
    }
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) part_m[qt * BR + r0 + r] = m_new[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = r0 + r;
      const float m_old = row_m[row];
      const float mt = fmaxf(fmaxf(part_m[row], part_m[BR + row]),
                             fmaxf(part_m[2 * BR + row], part_m[3 * BR + row]));
      m_new[r] = fmaxf(m_old, mt);
      const float corr = exp2f(m_old - m_new[r]);
#pragma unroll
      for (int j = 0; j < OC; ++j) o[r][j] *= corr;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[r][j] = exp2f(s[r][j] - m_new[r]);
        rs += s[r][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (kg == 0) part_l[qt * BR + row] = rs;
    }
    // P[key][row]: rows r0..r0+7 of keys 64 qt + kg + 8 j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = 64 * qt + kg + 8 * j;
      *reinterpret_cast<float4*>(Ps + p_off(key, r0)) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Ps + p_off(key, r0 + 4)) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();  // every row_m read, every partial sum written
    if (qt == 0 && kg == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = r0 + r;
        const float corr = exp2f(row_m[row] - m_new[r]);
        row_l[row] = row_l[row] * corr + part_l[row] + part_l[BR + row] +
                     part_l[2 * BR + row] + part_l[3 * BR + row];
        row_m[row] = m_new[r];
      }
    }

    // O += P V, VR kv rows a chunk: columns qt D/4 + 8 VW i + VW kg + e
    for (int c = 0; c < V_CHUNKS; ++c) {
      const float* st = next_stage();
#pragma unroll
      for (int jj = 0; jj < VR; ++jj) {
        const int key = c * VR + jj;
        const float4 pa =
            *reinterpret_cast<const float4*>(Ps + p_off(key, r0));
        const float4 pc =
            *reinterpret_cast<const float4*>(Ps + p_off(key, r0 + 4));
        const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pc.x, pc.y, pc.z, pc.w};
#pragma unroll
        for (int i = 0; i < OC / VW; ++i) {
          float v[VW];
          load_vec<VW>(st + v_off<D>(jj, qt * (D / 4) + 8 * VW * i + VW * kg),
                       v);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int e = 0; e < VW; ++e)
              o[r][VW * i + e] = fmaf(pv[r], v[e], o[r][VW * i + e]);
        }
      }
    }
  }
  // epilogue: O / l and the natural-log lse, straight to out and lse, or
  // (kv split) to this split's slice of the partial buffer
  const long long rows = (long long)a.batch * a.heads * a.seq_q;
  float* ob;
  long long o_ss;
  float* lse;
  if (args.kv_splits == 1) {
    ob = static_cast<float*>(a.o) + (long long)b * a.seq_q * a.heads * D +
         h * D;
    o_ss = (long long)a.heads * D;
    lse = a.lse + ((long long)b * a.heads + h) * a.seq_q;
  } else {
    ob = args.part + (split * rows + ((long long)b * a.heads + h) * a.seq_q) *
                         D;
    o_ss = D;
    lse = args.part + rows * D * args.kv_splits + split * rows +
          ((long long)b * a.heads + h) * a.seq_q;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int q = q0 + r0 + r;
    if (q >= a.seq_q) continue;
    const float l = row_l[r0 + r] == 0.f ? 1.f : row_l[r0 + r];
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < OC / VW; ++i) {
      float* dst = ob + q * o_ss + qt * (D / 4) + 8 * VW * i + VW * kg;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(o[r][4 * i] * inv, o[r][4 * i + 1] * inv,
                        o[r][4 * i + 2] * inv, o[r][4 * i + 3] * inv);
      else
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[r][2 * i] * inv, o[r][2 * i + 1] * inv);
    }
    if (qt == 0 && kg == 0)
      lse[q] = (row_m[r0 + r] + log2f(l)) * (1.0f / kLog2e);
  }
}

template <int D>
int launch(const FlashArgs& a, int kv_splits, float* part,
           cudaStream_t stream) {
  using C = FmaCfg<D>;
  const SplitArgs args = split_args(a, (a.seq_k + BC - 1) / BC, kv_splits,
                                    part);
  if (args.kv_splits < 0) return -2;
  CUtensorMap tk, tv;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static std::atomic<uint64_t> smem_set{0};
  const int dev = current_device();
  if (dev < 0) return -dev;
  int err = cached_bshd_tensor_map(&tk, F32, 4, a.k, a.batch, a.seq_k,
                                   a.heads, D, a.k_sb, a.k_ss, a.k_sh, DK,
                                   BC, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = cached_bshd_tensor_map(&tv, F32, 4, a.v, a.batch, a.seq_k,
                                 a.heads, D, a.v_sb, a.v_ss, a.v_sh,
                                 C::V_BOX, C::VR, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err < 0 ? err : -1000 - err;  // a CUresult
  auto kern = flash_fwd_f32_kernel<D>;
  err = allow_smem_once(kern, (int)C::SMEM, dev, smem_set);
  if (err != 0) return err;
  dim3 grid((a.seq_q + BR - 1) / BR, a.heads * kv_splits, a.batch);
  kern<<<grid, THREADS, C::SMEM, stream>>>(tk, tv, args);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_fwd_f32(int head_dim, const FlashArgs& a, int kv_splits,
                  float* part, cudaStream_t stream) {
  switch (head_dim) {
    case 128: return launch<128>(a, kv_splits, part, stream);
    case 192: return launch<192>(a, kv_splits, part, stream);
    case 256: return launch<256>(a, kv_splits, part, stream);
    case 320: return launch<320>(a, kv_splits, part, stream);
    case 384: return launch<384>(a, kv_splits, part, stream);
    case 448: return launch<448>(a, kv_splits, part, stream);
    case 512: return launch<512>(a, kv_splits, part, stream);
    default: return -2;
  }
}

}  // namespace vst
