// K4: flash-attention backward for Hopper.
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_dqkv_kernel` (one kv block covers the sequence) and `_dq_kernel` +
// `_dkv_kernel` (the split form), all launched by `_flash_bwd_bhsd`.
//
// From the saved natural-log lse (B, H, Sq) of K1 and delta = rowsum(dO *
// O) (a kernel of its own below; XLA computes it in JAX), per (batch,
// head):
//   p  = exp(q k^T * scale - lse)      recomputed, never stored
//   dp = dO v^T,  ds = p (dp - delta) scale
//   dq = ds k,  dk = ds^T q,  dv = p^T dO
// with f32 logits and accumulators; p and ds are rounded to the input type
// before their products, as the JAX kernels round them. q, k, v are
// (B, S, H, D) strided views (the layout K1 reads); dO is (B, Sq, H*D)
// contiguous; dq, dk, dv are written (B, S, H, D) contiguous.
//
// Bound on the H100: ~10 * Sq * Sk * D flops per (batch, head) (the JAX
// cost estimate) against ~8 * S * D elements of traffic is far above the
// card's ~295 flop/byte ridge at the UNet shapes: the kernels are bound by
// tensor-core throughput (bf16, and TF32 at three products a product for
// fp32).
//
// Design: the two-kernel form. The TPU's fused `nk == 1` kernel leans on
// one kv block covering the whole sequence in VMEM; here a block holds at
// most 227 KB of shared memory and blocks run in no order, so
//  - the dk/dv kernel owns one kv tile of one (batch, head) and walks
//    every q tile, accumulating dk and dv in f32;
//  - the dq kernel owns one q tile and walks every kv tile, accumulating
//    dq.
// Neither needs atomics, and both are deterministic. Each recomputes S and
// dP, so the pair does 14 rather than 10 * Sq * Sk * D flops. At d = 64
// (every SDXL UNet head) two routes (`bwd_route` in
// ops/flash_attention.py):
//  - bf16 (every K4 call of the training paths): wgmma + TMA,
//    warp-specialised, as K1's bf16 route (below, `_sm90_`);
//  - fp32 (--mixed_precision no, and the card-vs-CPU reference step):
//    mma.sync at 3xTF32 with cp.async tiles, in flash_attention_tf32.cu
//    beside K1's fp32 d = 64 forward.
// At d = 128-512 (the VAE's mid-block attention, d = 512, under a
// gradient) the same two-kernel form with D split across the blocks of a
// cluster: bf16 in flash_attention_bwd_sliced.cu, fp32 on TF32 wgmma at
// 3xTF32 in flash_attention_bwd_sliced_tf32.cu.
// This file also holds the delta kernel every route takes, and the C
// entry point. The kv and q tails are zero-filled and masked.

#include "common.cuh"
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace vst {
namespace {

using namespace sm90;

// ------------------------------------------------ bf16: wgmma + TMA
//
// The stage-2 path's every K4 call is bf16 at d = 64. Both kernels are
// K1's wgmma route turned to the backward: a producer warpgroup (one
// thread issues the TMA loads, one warp stages the lse and delta rows;
// setmaxnreg 40) and two consumer warpgroups of 64 rows each
// (setmaxnreg 232), 384 threads, one block an SM.
//  - dk/dv kernel: a block owns 128 kv rows of one (batch, head). K and V
//    arrive once; 64-row Q and dO tiles stream through a ring of NST
//    stages, each with its rows' lse (log2 units) and delta. Per tile a
//    consumer forms S^T = K Q^T and dP^T = V dO^T (wgmma, both operands
//    K-major in shared memory), turns them into P^T and dS^T in registers
//    (the accumulator of one product is already the A fragment of the
//    next), then dV += P^T dO and dK += dS^T Q with dO and Q read MN-major
//    through the transpose bit, as K1 reads V. dK and dV stay in f32
//    registers for the whole q walk.
//  - dq kernel: a block owns 128 q rows; Q and dO arrive once, K and V
//    tiles of 128 keys stream through the ring. S = Q K^T and dP = dO
//    V^T, dS in registers, dQ += dS K with K MN-major. The lse is known,
//    so there is no running max and no rescale. (64-key tiles measured
//    3 % slower on an H100 at the train step's level 1, the same at
//    level 2.)
// Consumers hand stages back on "empty" barriers; no block-wide barrier
// runs inside the loops. Every TMA box is a whole tile that starts inside
// its sequence, so rows past the end arrive as zeros; masked q columns
// (dk/dv) and kv columns (dq) get p = ds = 0 before any product. The
// registers hold d = 64: S^T, dP^T, dK and dV take 32 floats a thread each.

template <int D>
struct DkvCfg {
  static constexpr int BKV = 128;  // kv rows a block: two warpgroups x 64
  static constexpr int BQ = 64;    // q rows a streamed tile
  static constexpr int NST = 3;    // ring stages
  static constexpr uint32_t KV_PANEL = BKV * 128;  // one 64-wide panel
  static constexpr uint32_t KV_BYTES = KV_PANEL * (D / 64);
  static constexpr uint32_t Q_PANEL = BQ * 128;
  static constexpr uint32_t Q_BYTES = Q_PANEL * (D / 64);
  static constexpr size_t OFF_V = KV_BYTES;
  static constexpr size_t OFF_Q = 2 * KV_BYTES;  // [NST] Q tiles
  static constexpr size_t OFF_DO = OFF_Q + NST * Q_BYTES;
  static constexpr size_t OFF_ROW = OFF_DO + NST * Q_BYTES;  // [NST][2][BQ]
  static constexpr size_t OFF_BAR = OFF_ROW + NST * 2 * BQ * sizeof(float);
  // barriers: K/V, full[NST], empty[NST]; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * NST) + 1024;
  static_assert(D == 64, "registers hold d = 64");
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

template <int D>
struct DqCfg {
  static constexpr int BR = 128;  // q rows a block: two warpgroups x 64
  static constexpr int BC = 128;  // keys a streamed tile
  static constexpr int NST = 3;
  static constexpr uint32_t Q_PANEL = BR * 128;
  static constexpr uint32_t Q_BYTES = Q_PANEL * (D / 64);
  static constexpr uint32_t KV_PANEL = BC * 128;
  static constexpr uint32_t KV_BYTES = KV_PANEL * (D / 64);
  static constexpr size_t OFF_DO = Q_BYTES;
  static constexpr size_t OFF_K = 2 * Q_BYTES;  // [NST] K tiles
  static constexpr size_t OFF_V = OFF_K + NST * KV_BYTES;
  static constexpr size_t OFF_BAR = OFF_V + NST * KV_BYTES;
  // barriers: Q/dO, full[NST], empty[NST]; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * NST) + 1024;
  static_assert(D == 64, "registers hold d = 64");
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// rows `row0` and `row0 + 8` of a warpgroup's (64, D) f32 accumulator ->
// a contiguous (B, S, H, D) bf16 output at (b, h)
template <int D>
__device__ __forceinline__ void store_acc(bf16* out, const float* acc,
                                          int b, int h, int row0, int seq,
                                          int heads, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq) continue;
    bf16* o = out + (((long long)b * seq + row) * heads + h) * D + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i) =
          pack_bf16x2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const BwdArgs a) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, NST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* rows = reinterpret_cast<float*>(smem + C::OFF_ROW);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + NST;

  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * C::BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = (a.seq_q + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1 + 32);  // the TMA thread and the row warp
      mbar_init(&empty[i], 8);      // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(smem + p * C::KV_PANEL, &tk, bar_kv, p * 64, h, k0, b);
        tma_load_4d(smem + C::OFF_V + p * C::KV_PANEL, &tv, bar_kv, p * 64,
                    h, k0, b);
      }
      for (int t = 0; t < nq; ++t) {
        const int st = t % NST;
        mbar_wait(&empty[st], ((t / NST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * C::Q_BYTES);
        unsigned char* qs = smem + C::OFF_Q + st * C::Q_BYTES;
        unsigned char* dos = smem + C::OFF_DO + st * C::Q_BYTES;
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(qs + p * C::Q_PANEL, &tq, &full[st], p * 64, h,
                      t * BQ, b);
          tma_load_4d(dos + p * C::Q_PANEL, &tdo, &full[st], p * 64, h,
                      t * BQ, b);
        }
      }
    } else if (warp == 1) {
      // lse (log2 units) and delta of each tile's rows; zero past Sq
      const long long bh = ((long long)b * a.heads + h) * a.seq_q;
      for (int t = 0; t < nq; ++t) {
        const int st = t % NST;
        mbar_wait(&empty[st], ((t / NST) & 1) ^ 1);
        float* rw = rows + st * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int q = t * BQ + r;
          const bool ok = q < a.seq_q;
          rw[r] = ok ? a.lse[bh + q] * kLog2e : 0.f;
          rw[BQ + r] = ok ? a.delta[bh + q] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    // this warpgroup's 64 kv rows start 64 rows into each K / V panel
    const uint32_t k_addr = smem_u32(smem) + c * 64 * 128;
    const uint32_t v_addr = smem_u32(smem + C::OFF_V) + c * 64 * 128;
    const float sl2 = a.scale * kLog2e;

    float dk[D / 2], dv[D / 2], s[BQ / 2], dp[BQ / 2];
    uint32_t pf[BQ / 16][4], sf[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < nq; ++t) {
      const int st = t % NST;
      const uint32_t q_addr = smem_u32(smem + C::OFF_Q + st * C::Q_BYTES);
      const uint32_t do_addr = smem_u32(smem + C::OFF_DO + st * C::Q_BYTES);
      const float* lr = rows + st * 2 * BQ;
      mbar_wait(&full[st], (t / NST) & 1);
      // S^T = K Q^T, then dP^T = V dO^T, committed as two groups
      fence_regs<BQ / 2>(s);
      fence_regs<BQ / 2>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(s, desc_kmajor(k_addr, C::KV_PANEL, kk),
                     desc_kmajor(q_addr, C::Q_PANEL, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ>(dp, desc_kmajor(v_addr, C::KV_PANEL, kk),
                     desc_kmajor(do_addr, C::Q_PANEL, kk), kk > 0);
      wgmma_commit();
      // this thread's q columns are 8i + 2 t4 + {0, 1}
      float2 lc[BQ / 8], dc[BQ / 8];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        lc[i] = *reinterpret_cast<const float2*>(lr + 8 * i + 2 * t4);
        dc[i] = *reinterpret_cast<const float2*>(lr + BQ + 8 * i + 2 * t4);
      }
      const int q_left = a.seq_q - t * BQ;  // columns at or past it: 0
      wgmma_wait<1>();
      fence_regs<BQ / 2>(s);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? lc[i].y : lc[i].x;
          const float p = ex2(fmaf(s[4 * i + e], sl2, -l));
          s[4 * i + e] = 8 * i + 2 * t4 + (e & 1) < q_left ? p : 0.f;
        }
      pack_a<BQ>(pf, s);
      wgmma_wait<0>();
      fence_regs<BQ / 2>(dp);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = (e & 1) ? dc[i].y : dc[i].x;
          const float ds = s[4 * i + e] * (dp[4 * i + e] - d) * a.scale;
          dp[4 * i + e] = 8 * i + 2 * t4 + (e & 1) < q_left ? ds : 0.f;
        }
      pack_a<BQ>(sf, dp);
      // dV += P^T dO, dK += dS^T Q; then hand the stage back
      fence_regs<D / 2>(dv);
      fence_regs<D / 2>(dk);
      fence_p<BQ / 16>(pf);
      fence_p<BQ / 16>(sf);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        wgmma_rs_vt<D>(dv, pf[j], desc_mnmajor(do_addr, C::Q_PANEL, j), 1);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        wgmma_rs_vt<D>(dk, sf[j], desc_mnmajor(q_addr, C::Q_PANEL, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dv);
      fence_regs<D / 2>(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    const int row0 = k0 + c * 64 + warp * 16 + lane / 4;
    store_acc<D>(static_cast<bf16*>(a.dk), dk, b, h, row0, a.seq_k, a.heads,
                 t4);
    store_acc<D>(static_cast<bf16*>(a.dv), dv, b, h, row0, a.seq_k, a.heads,
                 t4);
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const BwdArgs a) {
  using C = DqCfg<D>;
  constexpr int BC = C::BC, NST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + NST;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * C::BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = (a.seq_k + BC - 1) / BC;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(smem + p * C::Q_PANEL, &tq, bar_q, p * 64, h, q0, b);
        tma_load_4d(smem + C::OFF_DO + p * C::Q_PANEL, &tdo, bar_q, p * 64,
                    h, q0, b);
      }
      for (int t = 0; t < nk; ++t) {
        const int st = t % NST;
        mbar_wait(&empty[st], ((t / NST) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * C::KV_BYTES);
        unsigned char* ks = smem + C::OFF_K + st * C::KV_BYTES;
        unsigned char* vs = smem + C::OFF_V + st * C::KV_BYTES;
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(ks + p * C::KV_PANEL, &tk, &full[st], p * 64, h,
                      t * BC, b);
          tma_load_4d(vs + p * C::KV_PANEL, &tv, &full[st], p * 64, h,
                      t * BC, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    // this warpgroup's 64 rows start 64 rows into each Q / dO panel
    const uint32_t q_addr = smem_u32(smem) + c * 64 * 128;
    const uint32_t do_addr = smem_u32(smem + C::OFF_DO) + c * 64 * 128;
    const float sl2 = a.scale * kLog2e;
    const int row0 = q0 + c * 64 + warp * 16 + lane / 4;

    // lse (log2 units) and delta of this thread's rows row0, row0 + 8
    float lr[2], dr[2];
    const long long bh = ((long long)b * a.heads + h) * a.seq_q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row0 + 8 * r < a.seq_q;
      lr[r] = ok ? a.lse[bh + row0 + 8 * r] * kLog2e : 0.f;
      dr[r] = ok ? a.delta[bh + row0 + 8 * r] : 0.f;
    }
    float dq[D / 2], s[BC / 2], dp[BC / 2];
    uint32_t sf[BC / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) s[i] = dp[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < nk; ++t) {
      const int st = t % NST;
      const uint32_t k_addr = smem_u32(smem + C::OFF_K + st * C::KV_BYTES);
      const uint32_t v_addr = smem_u32(smem + C::OFF_V + st * C::KV_BYTES);
      mbar_wait(&full[st], (t / NST) & 1);
      // S = Q K^T, then dP = dO V^T, committed as two groups
      fence_regs<BC / 2>(s);
      fence_regs<BC / 2>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC>(s, desc_kmajor(q_addr, C::Q_PANEL, kk),
                     desc_kmajor(k_addr, C::KV_PANEL, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BC>(dp, desc_kmajor(do_addr, C::Q_PANEL, kk),
                     desc_kmajor(v_addr, C::KV_PANEL, kk), kk > 0);
      wgmma_commit();
      const int k_left = a.seq_k - t * BC;  // columns at or past it: 0
      wgmma_wait<1>();
      fence_regs<BC / 2>(s);
#pragma unroll
      for (int i = 0; i < BC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[4 * i + e], sl2, -lr[e >> 1]));
          s[4 * i + e] = 8 * i + 2 * t4 + (e & 1) < k_left ? p : 0.f;
        }
      wgmma_wait<0>();
      fence_regs<BC / 2>(dp);
#pragma unroll
      for (int i = 0; i < BC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds =
              s[4 * i + e] * (dp[4 * i + e] - dr[e >> 1]) * a.scale;
          dp[4 * i + e] = 8 * i + 2 * t4 + (e & 1) < k_left ? ds : 0.f;
        }
      pack_a<BC>(sf, dp);
      // dQ += dS K; then hand the stage back
      fence_regs<D / 2>(dq);
      fence_p<BC / 16>(sf);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BC / 16; ++j)
        wgmma_rs_vt<D>(dq, sf[j], desc_mnmajor(k_addr, C::KV_PANEL, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dq);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    store_acc<D>(static_cast<bf16*>(a.dq), dq, b, h, row0, a.seq_q, a.heads,
                 t4);
  }
}

int launch_sm90(const BwdArgs& a, cudaStream_t stream) {
  constexpr int D = 64;
  using Ckv = DkvCfg<D>;
  using Cq = DqCfg<D>;
  static_assert(Cq::BC == Ckv::BKV, "the K and V maps serve both kernels");
  // 4-D (D, H, S, B) maps of the strided views, boxes of 64 values of D
  // (one 128-byte swizzled panel) by a whole tile's rows
  auto map = [&](CUtensorMap* m, const void* p, int seq, long long sb,
                 long long ss, long long sh, int rows) {
    return bshd_tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p,
                           a.batch, seq, a.heads, D, sb, ss, sh, 64, rows,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const long long do_ss = (long long)a.heads * D;
  const long long do_sb = (long long)a.seq_q * do_ss;
  CUtensorMap q_t, do_t, k_blk, v_blk, q_blk, do_blk;
  int e = map(&q_t, a.q, a.seq_q, a.q_sb, a.q_ss, a.q_sh, Ckv::BQ);
  if (e == 0) e = map(&do_t, a.dout, a.seq_q, do_sb, do_ss, D, Ckv::BQ);
  if (e == 0)
    e = map(&k_blk, a.k, a.seq_k, a.k_sb, a.k_ss, a.k_sh, Ckv::BKV);
  if (e == 0)
    e = map(&v_blk, a.v, a.seq_k, a.v_sb, a.v_ss, a.v_sh, Ckv::BKV);
  if (e == 0) e = map(&q_blk, a.q, a.seq_q, a.q_sb, a.q_ss, a.q_sh, Cq::BR);
  if (e == 0) e = map(&do_blk, a.dout, a.seq_q, do_sb, do_ss, D, Cq::BR);
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  auto kdkv = flash_bwd_dkv_sm90_kernel<D>;
  auto kdq = flash_bwd_dq_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Ckv::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cq::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 gkv((a.seq_k + Ckv::BKV - 1) / Ckv::BKV, a.heads, a.batch);
  kdkv<<<gkv, 384, Ckv::SMEM, stream>>>(q_t, k_blk, v_blk, do_t, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gq((a.seq_q + Cq::BR - 1) / Cq::BR, a.heads, a.batch);
  kdq<<<gq, 384, Cq::SMEM, stream>>>(q_blk, k_blk, v_blk, do_blk, a);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- delta
//
// delta = rowsum(dO * O) of every (batch, q row, head), f32 sums, written
// (B, H, Sq): the row term of ds that every K4 kernel reads. dO and O are
// (B, Sq, H * D) contiguous, read once, 16 bytes a thread a load, so it is
// bound by their bytes. A row's D / VEC vectors go to TPR threads of one
// warp, the most (a power of two up to 32) that divides them evenly, each
// summing VPT of them (d = 64: one each), then a shuffle sum.
template <typename T, int D>
struct DeltaCfg {
  static constexpr int NV = D / Vec<T>::N;  // 16-byte vectors a row
  static constexpr int TPR = NV % 32 == 0 ? 32 : NV % 16 == 0 ? 16 : 8;
  static constexpr int VPT = NV / TPR;
  static_assert(NV % TPR == 0 && 32 % TPR == 0, "a row within a warp");
};

template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows,
                           int seq_q, int heads) {
  constexpr int VEC = Vec<T>::N, TPR = DeltaCfg<T, D>::TPR;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = i / TPR;  // (b, q, h)
  const int part = (int)(i % TPR);
  float acc = 0.f;
  if (row < rows) {
#pragma unroll
    for (int j = 0; j < DeltaCfg<T, D>::VPT; ++j) {
      float x[VEC], y[VEC];
      unpack16<T>(o + row * D + (part + TPR * j) * VEC, x);
      unpack16<T>(dout + row * D + (part + TPR * j) * VEC, y);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(x[e], y[e], acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows) {
    const long long bq = row / heads;
    const int h = (int)(row % heads);
    const long long b = bq / seq_q, q = bq % seq_q;
    delta[(b * heads + h) * seq_q + q] = acc;
  }
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int batch,
                 int seq_q, int heads, cudaStream_t stream) {
  constexpr int TPR = DeltaCfg<T, D>::TPR;
  const long long rows = (long long)batch * seq_q * heads;
  const long long blocks = (rows * TPR + 255) / 256;
  flash_bwd_delta_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
      seq_q, heads);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta_d(int head_dim, const void* o, const void* dout,
                   float* delta, int batch, int seq_q, int heads,
                   cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_delta<T, 64>(o, dout, delta, batch, seq_q, heads, s);
    case 128:
      return launch_delta<T, 128>(o, dout, delta, batch, seq_q, heads, s);
    case 192:
      return launch_delta<T, 192>(o, dout, delta, batch, seq_q, heads, s);
    case 256:
      return launch_delta<T, 256>(o, dout, delta, batch, seq_q, heads, s);
    case 320:
      return launch_delta<T, 320>(o, dout, delta, batch, seq_q, heads, s);
    case 384:
      return launch_delta<T, 384>(o, dout, delta, batch, seq_q, heads, s);
    case 448:
      return launch_delta<T, 448>(o, dout, delta, batch, seq_q, heads, s);
    case 512:
      return launch_delta<T, 512>(o, dout, delta, batch, seq_q, heads, s);
    default:
      return -2;
  }
}

}  // namespace
}  // namespace vst

extern "C" int vst_flash_attention_bwd(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, void* dq, void* dk,
    void* dv, int batch, int seq_q, int seq_k, int heads, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  vst::BwdArgs a{q,     k,     v,     dout,  static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dq, dk, dv, batch, seq_q,
                 seq_k, heads, q_sb,  q_ss,  q_sh, k_sb, k_ss, k_sh, v_sb,
                 v_ss,  v_sh,  scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seq_q < 1 || seq_k < 1) return -2;
  if (head_dim == 64) {
    if (dtype == vst::kFloat32) return vst::flash_bwd_tf32(a, s);
    if (dtype == vst::kBFloat16) return vst::launch_sm90(a, s);
    return -1;
  }
  // head_dim 128-512: the D-sliced kernels (the launchers refuse others)
  if (dtype == vst::kFloat32)
    return vst::flash_bwd_sliced_tf32(a, head_dim, s);
  if (dtype == vst::kBFloat16)
    return vst::flash_bwd_sliced_sm90(a, head_dim, s);
  return -1;
}

// delta = rowsum(dO * O), (B, H, Sq) f32, from (B, Sq, H * head_dim) O and
// dO. Returns 0, a CUDA error, or a negative code for an argument it
// refuses.
extern "C" int vst_flash_attention_bwd_delta(int dtype, int head_dim,
                                             const void* o, const void* dout,
                                             void* delta, int batch,
                                             int seq_q, int heads,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(delta);
  if (dtype == vst::kFloat32)
    return vst::launch_delta_d<float>(head_dim, o, dout, out, batch, seq_q,
                                      heads, s);
  if (dtype == vst::kBFloat16)
    return vst::launch_delta_d<vst::bf16>(head_dim, o, dout, out, batch,
                                          seq_q, heads, s);
  return -1;
}
