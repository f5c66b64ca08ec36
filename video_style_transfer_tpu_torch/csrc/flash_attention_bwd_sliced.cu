// K4 in bf16 at head dims 128-512: the flash-attention backward on wgmma
// + TMA, D split across the blocks of a thread-block cluster
// ("wgmma_sliced" route of ops/flash_attention.py's `bwd_route`).
//
// Replaces, for bf16 inputs at d = 128, 192, ..., 512, the JAX package's
// Pallas kernels ops/flash_attention.py `_dqkv_kernel` / `_dq_kernel` +
// `_dkv_kernel` (launched by `_flash_bwd_bhsd`), which are generic in d.
// The path that reaches them on the card is a gradient through the SDXL
// VAE (its mid-block attention: one head, d = 512) and any flash_attention
// call at d >= 128.
//
// The function is flash_attention_bwd.cu's, per (batch, head), from the
// saved lse and that file's delta = rowsum(dO * O):
//   p = exp(q k^T * scale - lse), dp = dO v^T, ds = p (dp - delta) scale,
//   dq = ds k, dk = ds^T q, dv = p^T dO,
// f32 accumulators, p and ds rounded to bf16 before their products.
//
// Bound on the H100: tensor-core throughput at 14 * Sq * Sk * D flops a
// (batch, head) (the two-kernel form forms S and dP once in each kernel;
// ~8 * S * D elements of traffic).
//
// Why d = 64's design does not carry over whole: its dk/dv kernel keeps
// dK and dV of 64 kv rows across the whole D in a warpgroup's registers.
// At d = 512 that is 256 floats a thread each.
//
// Design: the two-kernel form (no atomics, deterministic) as
// flash_attention_bwd.cu's d = 64 kernels, with D split across a cluster
// of NC = ceil(D / 128) blocks (`bwd_plan` in ops/flash_attention.py):
//  - Block `rank` owns columns [128 rank, 128 rank + 64 M) of D (M = 2
//    panels of 64, the last block 1 where D / 64 is odd) for 128 own rows
//    (keys for dk/dv, q rows for dq): two consumer warpgroups of 64 rows
//    each (setmaxnreg 240) and a producer warpgroup (24) whose one thread
//    keeps a ring of TMA stages full (64 streamed rows of both streamed
//    tensors a stage, the block's columns only) and one warp stages each
//    q tile's lse and delta (dk/dv). Every block of a cluster has the same
//    own rows.
//  - Per tile each warpgroup forms its share of S^T = K Q^T and dP^T = V
//    dO^T (S = Q K^T, dP = dO V^T for dq) over its block's columns,
//    m64n64 wgmmas. The shares are summed across the cluster through
//    distributed shared memory in two rounds, so that S and dP are formed
//    once (14 flops, nothing recomputed) and every block holds the same P
//    and dS bit for bit:
//      1. every block sends the block that owns a 16-column k step
//         (`sl_owner`) its f32 shares of that step; the owner adds them in
//         rank order, forms P and dS there and rounds them to bf16 A
//         fragments;
//      2. the owner sends those fragments to every other block.
//    The sends are st.async stores into the receiver's shared memory, each
//    completing its bytes on a receive barrier of the receiving warpgroup,
//    which expects a round's bytes once a tile: no fence, no remote
//    arrival, no load that waits on another SM. A block sends a round's
//    data again only after the next round's barrier of its own has
//    completed, which no receiver allows before it has read the last.
//    Only the owned k steps' shares cross distributed shared memory: 48
//    of the 64 KB of f32 shares a tile at NC = 4, and 24 KB of fragments.
//    Those bytes set the pace from d = 192 up: without the exchange
//    (`cli/profile_step.py --k4_cutouts`, cut "no-exchange") the pair
//    takes 48-67 % of its time at d = 192-512 (PERF.md). Overlapping a round with the next tile's shares needs 64
//    registers more than a consumer has (ptxas serialised the wgmmas),
//    and alternating the two warpgroups on the tensor cores ran slower.
//  - Then dV += P^T dO and dK += dS^T Q (or dQ += dS K) over the block's
//    columns: register-A wgmmas, the streamed tile MN-major through the
//    transpose bit.
//  - Registers: dK and dV of the slice (64 floats a thread each at M = 2),
//    S^T and dP^T (32 each) and the A fragments; dq: dQ (64), S, dP. The
//    consumer is a template on the block's rank, so that the k steps it
//    owns, and with them which registers stay live, are known to ptxas
//    (with a runtime rank the dk/dv kernels spilled).
// At d = 128 the cluster is one block and nothing is exchanged.
//
// Every TMA box starts inside its sequence, so rows past the end arrive
// as zeros; streamed columns past the end get p = ds = 0 before any
// product, and output rows past the end are not written.

#include "common.cuh"
#include "flash_attention.cuh"
#include "sm90.cuh"

// VST_K4_CUTOUT (cli/profile_step.py --k4_cutouts) cuts the kernels: 1
// keeps the loads and stores alone (what is stored is not the gradients),
// 2 keeps the compute on data that stays in L2 (every streamed tile is
// the sequence's first), 3 skips the exchange through distributed shared
// memory (each block forms P and dS from its own shares alone)
#ifndef VST_K4_CUTOUT
#define VST_K4_CUTOUT 0
#endif

namespace vst {
namespace {

using namespace sm90;

constexpr int SL_ROWS = 128;       // own rows a block: two warpgroups x 64
constexpr int SL_BN = 64;          // streamed rows a tile, both kernels
constexpr int SL_MAXP = 2;         // 64-wide panels of a block's columns
constexpr int SL_MAX_STAGES = 4;   // ring stages at most
constexpr uint32_t SL_OWN_PANEL = SL_ROWS * 128;           // 16 KB
constexpr uint32_t SL_STR_PANEL = SL_BN * 128;             // 8 KB
constexpr uint32_t SL_STAGE = 2 * SL_MAXP * SL_STR_PANEL;  // 32 KB
constexpr uint32_t SL_ROW_BYTES = 2 * SL_BN * 4;  // a tile's lse, delta
constexpr long long SL_SMEM_MAX = 232448;

// blocks a cluster: one a 128-column slice of D
__host__ __device__ constexpr int sl_cluster(int np) {
  return (np + SL_MAXP - 1) / SL_MAXP;
}

// the block of an NC-block cluster that owns k step j (16 streamed
// columns) of a tile, and j's place among that block's k steps
__host__ __device__ constexpr int sl_owner(int nc, int j) {
  return nc == 1 ? 0 : nc == 2 ? j / 2 : nc == 3 ? (j < 2 ? 0 : j - 1) : j;
}
__host__ __device__ constexpr int sl_place(int nc, int j) {
  return nc == 1 ? j : nc == 2 ? j % 2 : nc == 3 ? (j < 2 ? j : 0) : 0;
}

// barriers (128 bytes), then the dk/dv kernel's rows, to a kilobyte
__host__ __device__ constexpr long long sl_head(bool dq, int nst) {
  return (128 + (dq ? 0 : nst * SL_ROW_BYTES) + 1023) / 1024 * 1024;
}

// the most k steps one block of an NC-block cluster owns
__host__ __device__ constexpr int sl_most_owned(int nc) {
  return nc == 4 ? 1 : 2;
}

// a consumer warpgroup's receive buffers, a uint4 a thread each slot:
// round 1, from each other block the f32 shares of S and dP of the k
// steps this block owns (4 slots a k step: two n tiles of S, two of dP);
// round 2, the bf16 fragments of P (dk/dv) and dS of every k step (2 or
// 1 slots a k step)
__host__ __device__ constexpr long long sl_r1_bytes(int nc) {
  return (nc - 1) * 4LL * sl_most_owned(nc) * 128 * 16;
}
__host__ __device__ constexpr long long sl_r2_bytes(bool dq) {
  return 4LL * (dq ? 1 : 2) * 128 * 16;
}

__host__ __device__ constexpr long long sl_smem(bool dq, int np, int nst) {
  return 1024 + sl_head(dq, nst) + 2LL * SL_MAXP * SL_OWN_PANEL +
         (long long)nst * SL_STAGE +
         (sl_cluster(np) > 1
              ? 2 * (sl_r1_bytes(sl_cluster(np)) + sl_r2_bytes(dq))
              : 0);
}

// the ring stages that fit (`bwd_plan` computes the same)
__host__ __device__ constexpr int sl_stages(bool dq, int np) {
  int n = SL_MAX_STAGES;
  while (n > 1 && sl_smem(dq, np, n) > SL_SMEM_MAX) --n;
  return n;
}

// `bwd_plan`'s stages and clusters; every k step has one owner, so the
// pair forms S and dP once: 14 * Sq * Sk * D flops at every d
static_assert(sl_stages(false, 2) == 4 && sl_stages(true, 2) == 4,
              "bwd_plan's stages at d = 128");
static_assert(sl_stages(false, 3) == 3 && sl_stages(true, 3) == 3 &&
                  sl_stages(false, 5) == 2 && sl_stages(true, 5) == 2 &&
                  sl_stages(false, 8) == 2 && sl_stages(true, 8) == 3,
              "bwd_plan's stages beside the receive buffers");
static_assert(sl_cluster(2) == 1 && sl_cluster(3) == 2 &&
                  sl_cluster(5) == 3 && sl_cluster(8) == 4,
              "bwd_plan's clusters");
static_assert(sl_owner(4, 3) == 3 && sl_owner(3, 3) == 2 &&
                  sl_owner(3, 2) == 1 && sl_owner(2, 1) == 0 &&
                  sl_place(3, 1) == 1 && sl_place(2, 3) == 1,
              "one owner a k step");
static_assert(SL_BN / 16 == 4, "four k steps a tile, at most four blocks");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// a warpgroup's (64, 64 M) f32 accumulator, rows row0 and row0 + 8 ->
// a contiguous (B, S, H, D) bf16 output at (b, h), columns c0 ..
template <int M>
__device__ __forceinline__ void store_slice(bf16* out, const float* acc,
                                            int b, int h, int row0, int seq,
                                            int heads, int d, int c0,
                                            int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq) continue;
    bf16* o = out + (((long long)b * seq + row) * heads + h) * d + c0 + 2 * t4;
#pragma unroll
    for (int i = 0; i < 8 * M; ++i)
      *reinterpret_cast<uint32_t*>(o + 8 * i) =
          pack_bf16x2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

struct SlicedSmem {
  uint64_t* bar_own;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* xa;  // [2] round 1: the other blocks' shares received
  uint64_t* xb;  // [2] round 2: the other blocks' fragments received
  const float* rows;
  uint32_t own0, own1, ring;
  unsigned char* r1;  // [2 warpgroups] round 1 receive buffers
  unsigned char* r2;  // [2 warpgroups] round 2 receive buffers
};

// A consumer warpgroup of block RANK (M = its 64-wide panels of D).
// DQ = false: the dk/dv kernel (own K, V; streams Q, dO; S^T = K Q^T,
// dP^T = V dO^T). DQ = true: the dq kernel (own Q, dO; streams K, V; S =
// Q K^T, dP = dO V^T). RANK is a template argument so that the k steps a
// block owns, and with them which registers stay live, are known to the
// compiler.
template <bool DQ, int NP, int RANK>
__device__ __forceinline__ void sliced_consumer(const SlicedSmem& sm,
                                                const BwdArgs& a, int r0,
                                                int h, int b) {
  constexpr int NC = sl_cluster(NP);
  constexpr int NST = sl_stages(DQ, NP);
  constexpr int M = NP - SL_MAXP * RANK < SL_MAXP ? NP - SL_MAXP * RANK
                                                  : SL_MAXP;
  constexpr int P0 = SL_MAXP * RANK;  // the block's first panel
  constexpr int MOST = sl_most_owned(NC);
  constexpr bool XCH = NC > 1 && VST_K4_CUTOUT != 3;
  const int c = threadIdx.x / 128 - 1;  // own rows 64 c .. of the block's
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const uint32_t o0 = sm.own0 + c * 64 * 128, o1 = sm.own1 + c * 64 * 128;
  const float sl2 = a.scale * kLog2e;
  const long long bh = ((long long)b * a.heads + h) * a.seq_q;
  const int row0 = r0 + 64 * c + warp * 16 + lane / 4;  // this thread's
  const int seq_own = DQ ? a.seq_q : a.seq_k;
  const int seq_str = DQ ? a.seq_k : a.seq_q;
  const int nt = (seq_str + SL_BN - 1) / SL_BN;
  // this thread's slot 0 of this warpgroup's receive buffers; slot i is
  // 2048 bytes further
  const float4* r1 = reinterpret_cast<const float4*>(
                         sm.r1 + c * sl_r1_bytes(NC)) + tid;
  const uint4* r2 =
      reinterpret_cast<const uint4*>(sm.r2 + c * sl_r2_bytes(DQ)) + tid;
  const uint32_t r1_addr = smem_u32(r1), r2_addr = smem_u32(r2);
  const uint32_t xa_addr = smem_u32(&sm.xa[c]), xb_addr = smem_u32(&sm.xb[c]);
  // the bytes a tile's rounds bring this warpgroup: from each other block
  // 4 n tiles of S and dP a k step this block owns; the fragments (P and
  // dS, or dS) of every k step it does not own
  constexpr int PER = DQ ? 1 : 2;
  constexpr int OWNED = (sl_owner(NC, 0) == RANK) + (sl_owner(NC, 1) == RANK) +
                        (sl_owner(NC, 2) == RANK) + (sl_owner(NC, 3) == RANK);
  constexpr uint32_t R1_TX = (NC - 1) * OWNED * 4 * 128 * 16;
  constexpr uint32_t R2_TX = (4 - OWNED) * PER * 128 * 16;

  // dK (dk/dv) or dQ (dq), and dV (dk/dv); 32 floats a panel
  float acc0[32 * M], acc1[DQ ? 1 : 32 * M];
  float s[SL_BN / 2], dp[SL_BN / 2];
  uint32_t pf[SL_BN / 16][4], sf[SL_BN / 16][4];
#pragma unroll
  for (int i = 0; i < 32 * M; ++i) acc0[i] = 0.f;
  if constexpr (!DQ) {
#pragma unroll
    for (int i = 0; i < 32 * M; ++i) acc1[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < SL_BN / 2; ++i) s[i] = dp[i] = 0.f;
  // dq: lse (log2 units) and delta of this thread's rows row0, row0 + 8
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row0 + 8 * r < a.seq_q;
      lr[r] = ok ? a.lse[bh + row0 + 8 * r] * kLog2e : 0.f;
      dr[r] = ok ? a.delta[bh + row0 + 8 * r] : 0.f;
    }
  }

  mbar_wait(sm.bar_own, 0);
  for (int t = 0; t < nt; ++t) {
    const int st = t % NST;
    const uint32_t s0 = sm.ring + st * SL_STAGE;
    const uint32_t s1 = s0 + SL_MAXP * SL_STR_PANEL;
    mbar_wait(&sm.full[st], (t / NST) & 1);
#if VST_K4_CUTOUT == 1
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    continue;
#endif
    if (XCH && tid == 0) {
      // this tile's phases of the receive barriers: the last tile's are
      // complete (waited), and what arrives early counts below zero
      mbar_arrive_tx(&sm.xa[c], R1_TX);
      mbar_arrive_tx(&sm.xb[c], R2_TX);
    }
    // this warpgroup's shares of S (S^T) and dP (dP^T) over the block's
    // columns
    fence_regs<SL_BN / 2>(s);
    fence_regs<SL_BN / 2>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * M; ++kk)
      wgmma_ss<SL_BN>(s, desc_kmajor(o0, SL_OWN_PANEL, kk),
                      desc_kmajor(s0, SL_STR_PANEL, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4 * M; ++kk)
      wgmma_ss<SL_BN>(dp, desc_kmajor(o1, SL_OWN_PANEL, kk),
                      desc_kmajor(s1, SL_STR_PANEL, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<SL_BN / 2>(s);
    fence_regs<SL_BN / 2>(dp);

    if constexpr (XCH) {
      // round 1: send each other block the shares of the k steps it owns
      // (into slot RANK, less one past its own rank, of its buffer),
      // then sum the owned k steps' shares in rank order
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        if (r == RANK) continue;
        const int from = RANK < r ? RANK : RANK - 1;
        const uint32_t bar = mapa(xa_addr, r);
#pragma unroll
        for (int j = 0; j < SL_BN / 16; ++j) {
          if (sl_owner(NC, j) != r) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* x = (q < 2 ? s : dp) + 4 * (2 * j + (q & 1));
            const int slot = (from * MOST + sl_place(NC, j)) * 4 + q;
            st_async_f4(mapa(r1_addr + slot * 2048, r),
                        make_float4(x[0], x[1], x[2], x[3]), bar);
          }
        }
      }
      mbar_wait_cluster(&sm.xa[c], t & 1);
#pragma unroll
      for (int j = 0; j < SL_BN / 16; ++j) {
        if (sl_owner(NC, j) != RANK) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* x = (q < 2 ? s : dp) + 4 * (2 * j + (q & 1));
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < NC; ++r) {
            const int from = r < RANK ? r : r - 1;
            const float4 v =
                r == RANK ? make_float4(x[0], x[1], x[2], x[3])
                          : r1[((from * MOST + sl_place(NC, j)) * 4 + q) *
                               128];
            if (r == 0) {
              sum = v;
            } else {
              sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
            }
          }
          x[0] = sum.x, x[1] = sum.y, x[2] = sum.z, x[3] = sum.w;
        }
      }
    }

    // P and dS (streamed columns at or past the end: 0) of the owned k
    // steps, rounded to bf16 A fragments
    const int left = seq_str - t * SL_BN;
    const float* rw = sm.rows + st * 2 * SL_BN;
#pragma unroll
    for (int j = 0; j < SL_BN / 16; ++j) {
      if (XCH && sl_owner(NC, j) != RANK) continue;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int i = 2 * j + ii;
        float2 lc = make_float2(0.f, 0.f), dc = lc;
        if constexpr (!DQ) {
          lc = *reinterpret_cast<const float2*>(rw + 8 * i + 2 * t4);
          dc = *reinterpret_cast<const float2*>(rw + SL_BN + 8 * i + 2 * t4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = DQ ? lr[e >> 1] : (e & 1) ? lc.y : lc.x;
          const float dl = DQ ? dr[e >> 1] : (e & 1) ? dc.y : dc.x;
          const bool ok = 8 * i + 2 * t4 + (e & 1) < left;
          const float p = ex2(fmaf(s[4 * i + e], sl2, -l));
          dp[4 * i + e] = ok ? p * (dp[4 * i + e] - dl) * a.scale : 0.f;
          s[4 * i + e] = ok ? p : 0.f;
        }
        if constexpr (!DQ) {
          pf[j][2 * ii] = pack_bf16x2(s[4 * i], s[4 * i + 1]);
          pf[j][2 * ii + 1] = pack_bf16x2(s[4 * i + 2], s[4 * i + 3]);
        }
        sf[j][2 * ii] = pack_bf16x2(dp[4 * i], dp[4 * i + 1]);
        sf[j][2 * ii + 1] = pack_bf16x2(dp[4 * i + 2], dp[4 * i + 3]);
      }
    }

    if constexpr (XCH) {
      // round 2: send every other block the owned k steps' fragments
      // (slots 2 j, 2 j + 1 for dk/dv, j for dq), then take the other k
      // steps' from this block's buffer
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        if (r == RANK) continue;
        const uint32_t bar = mapa(xb_addr, r);
#pragma unroll
        for (int j = 0; j < SL_BN / 16; ++j) {
          if (sl_owner(NC, j) != RANK) continue;
          if constexpr (!DQ)
            st_async_f4(mapa(r2_addr + PER * j * 2048, r),
                        make_float4(__uint_as_float(pf[j][0]),
                                    __uint_as_float(pf[j][1]),
                                    __uint_as_float(pf[j][2]),
                                    __uint_as_float(pf[j][3])),
                        bar);
          st_async_f4(mapa(r2_addr + (PER * j + PER - 1) * 2048, r),
                      make_float4(__uint_as_float(sf[j][0]),
                                  __uint_as_float(sf[j][1]),
                                  __uint_as_float(sf[j][2]),
                                  __uint_as_float(sf[j][3])),
                      bar);
        }
      }
      mbar_wait_cluster(&sm.xb[c], t & 1);
#pragma unroll
      for (int j = 0; j < SL_BN / 16; ++j) {
        if (sl_owner(NC, j) == RANK) continue;
        if constexpr (!DQ) {
          const uint4 x = r2[PER * j * 128];
          pf[j][0] = x.x, pf[j][1] = x.y, pf[j][2] = x.z, pf[j][3] = x.w;
        }
        const uint4 y = r2[(PER * j + PER - 1) * 128];
        sf[j][0] = y.x, sf[j][1] = y.y, sf[j][2] = y.z, sf[j][3] = y.w;
      }
    }

    // dV += P^T dO and dK += dS^T Q, or dQ += dS K, over the block's
    // columns; then the stage goes back
    fence_regs<32 * M>(acc0);
    if constexpr (!DQ) {
      fence_regs<32 * M>(acc1);
      fence_p<SL_BN / 16>(pf);
    }
    fence_p<SL_BN / 16>(sf);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < SL_BN / 16; ++j) {
      if constexpr (!DQ)
        wgmma_rs_vt<64 * M>(acc1, pf[j], desc_mnmajor(s1, SL_STR_PANEL, j),
                            1);
      wgmma_rs_vt<64 * M>(acc0, sf[j], desc_mnmajor(s0, SL_STR_PANEL, j), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32 * M>(acc0);
    if constexpr (!DQ) fence_regs<32 * M>(acc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }
  const int d = 64 * NP;
  if constexpr (DQ) {
    store_slice<M>(static_cast<bf16*>(a.dq), acc0, b, h, row0, seq_own,
                   a.heads, d, 64 * P0, t4);
  } else {
    store_slice<M>(static_cast<bf16*>(a.dk), acc0, b, h, row0, seq_own,
                   a.heads, d, 64 * P0, t4);
    store_slice<M>(static_cast<bf16*>(a.dv), acc1, b, h, row0, seq_own,
                   a.heads, d, 64 * P0, t4);
  }
}

// The consumer of block `rank`, its rank made a template argument.
template <bool DQ, int NP>
__device__ __forceinline__ void sliced_consumers(const SlicedSmem& sm,
                                                 const BwdArgs& a, int r0,
                                                 int h, int b, int rank) {
  constexpr int NC = sl_cluster(NP);
  if (rank == 0) {
    sliced_consumer<DQ, NP, 0>(sm, a, r0, h, b);
  } else if constexpr (NC > 1) {
    if (rank == 1) {
      sliced_consumer<DQ, NP, 1>(sm, a, r0, h, b);
    } else if constexpr (NC > 2) {
      if (rank == 2) {
        sliced_consumer<DQ, NP, 2>(sm, a, r0, h, b);
      } else if constexpr (NC > 3) {
        sliced_consumer<DQ, NP, 3>(sm, a, r0, h, b);
      }
    }
  }
}

// NP = D / 64 panels. NP is a template argument so that every walk over
// panels and k steps unrolls: with a runtime walk, ptxas serialises the
// kernel's wgmmas (accumulators carried across a loop's back edge while a
// group is in flight).
template <bool DQ, int NP>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_sliced_sm90_kernel(const __grid_constant__ CUtensorMap t_own0,
                                 const __grid_constant__ CUtensorMap t_own1,
                                 const __grid_constant__ CUtensorMap t_str0,
                                 const __grid_constant__ CUtensorMap t_str1,
                                 const BwdArgs a) {
  constexpr int NC = sl_cluster(NP);
  constexpr int NST = sl_stages(DQ, NP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  SlicedSmem sm;
  sm.bar_own = reinterpret_cast<uint64_t*>(smem);
  sm.full = sm.bar_own + 1;
  sm.empty = sm.full + SL_MAX_STAGES;
  sm.xa = sm.empty + SL_MAX_STAGES;
  sm.xb = sm.xa + 2;
  float* rows = reinterpret_cast<float*>(smem + 128);
  sm.rows = rows;
  unsigned char* own0 = smem + sl_head(DQ, NST);
  unsigned char* ring = own0 + 2 * SL_MAXP * SL_OWN_PANEL;
  unsigned char* xbase = ring + NST * SL_STAGE;
  sm.own0 = smem_u32(own0);
  sm.own1 = sm.own0 + SL_MAXP * SL_OWN_PANEL;
  sm.ring = smem_u32(ring);
  sm.r1 = xbase;
  sm.r2 = xbase + 2 * sl_r1_bytes(NC);

  const int wg = threadIdx.x / 128;
  const int rank = NC > 1 ? (int)cluster_ctarank() : 0;
  const int r0 = blockIdx.x / NC * SL_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int p0 = SL_MAXP * rank;          // the block's first panel
  const int m = min(SL_MAXP, NP - p0);    // and its panel count
  const int seq_str = DQ ? a.seq_k : a.seq_q;
  const int nt = (seq_str + SL_BN - 1) / SL_BN;

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_own, 1);
    for (int i = 0; i < NST; ++i) {
      mbar_init(&sm.full[i], DQ ? 1 : 1 + 32);  // TMA thread, row warp
      mbar_init(&sm.empty[i], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      // the receiving warpgroup's one arrival (with the bytes it expects)
      mbar_init(&sm.xa[i], 1);
      mbar_init(&sm.xb[i], 1);
    }
    mbar_init_fence();
  }
  // every block's barriers are initialised before any other block
  // arrives on them
  if constexpr (NC > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<24>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_arrive_tx(sm.bar_own, 2 * m * SL_OWN_PANEL);
      for (int p = 0; p < m; ++p) {
        tma_load_4d(own0 + p * SL_OWN_PANEL, &t_own0, sm.bar_own,
                    (p0 + p) * 64, h, r0, b);
        tma_load_4d(own0 + (SL_MAXP + p) * SL_OWN_PANEL, &t_own1,
                    sm.bar_own, (p0 + p) * 64, h, r0, b);
      }
      for (int t = 0; t < nt; ++t) {
        const int st = t % NST;
        const int row = VST_K4_CUTOUT == 2 ? 0 : t * SL_BN;
        mbar_wait(&sm.empty[st], ((t / NST) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[st], 2 * m * SL_STR_PANEL);
        unsigned char* s0 = ring + st * SL_STAGE;
        for (int p = 0; p < m; ++p) {
          tma_load_4d(s0 + p * SL_STR_PANEL, &t_str0, &sm.full[st],
                      (p0 + p) * 64, h, row, b);
          tma_load_4d(s0 + (SL_MAXP + p) * SL_STR_PANEL, &t_str1,
                      &sm.full[st], (p0 + p) * 64, h, row, b);
        }
      }
    } else if (!DQ && warp == 1) {
      // lse (log2 units) and delta of each q tile's rows; zero past Sq
      const long long bh = ((long long)b * a.heads + h) * a.seq_q;
      for (int t = 0; t < nt; ++t) {
        const int st = t % NST;
        mbar_wait(&sm.empty[st], ((t / NST) & 1) ^ 1);
        float* rw = rows + st * 2 * SL_BN;
        for (int r = lane; r < SL_BN; r += 32) {
          const int q = t * SL_BN + r;
          const bool ok = q < a.seq_q;
          rw[r] = ok ? a.lse[bh + q] * kLog2e : 0.f;
          rw[SL_BN + r] = ok ? a.delta[bh + q] : 0.f;
        }
        mbar_arrive(&sm.full[st]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    sliced_consumers<DQ, NP>(sm, a, r0, h, b, rank);
  }
  // no block leaves while another may still read its shared memory
  if constexpr (NC > 1) cluster_sync();
}

template <bool DQ, int NP>
int launch_sliced(const BwdArgs& a, int dev, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr int NC = sl_cluster(NP);
  constexpr int d = 64 * NP;
  constexpr long long smem = sl_smem(DQ, NP, sl_stages(DQ, NP));
  static_assert(smem <= SL_SMEM_MAX, "tiles exceed shared memory");
  auto kernel = flash_bwd_sliced_sm90_kernel<DQ, NP>;
  int e = allow_smem_once(kernel, (int)smem, dev, smem_set);
  if (e != 0) return e;
  // 4-D (D, H, S, B) maps of the strided views, boxes of one 64-wide
  // panel by the own (128) or streamed (64) rows
  auto map = [&](CUtensorMap* t, const void* p, int seq, long long sb,
                 long long ss, long long sh, int rows) {
    return cached_bshd_tensor_map(t, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p,
                                  a.batch, seq, a.heads, d, sb, ss, sh, 64,
                                  rows, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const long long do_ss = (long long)a.heads * d;
  const long long do_sb = (long long)a.seq_q * do_ss;
  const int q_rows = DQ ? SL_ROWS : SL_BN, kv_rows = DQ ? SL_BN : SL_ROWS;
  CUtensorMap tq, tdo, tk, tv;
  e = map(&tq, a.q, a.seq_q, a.q_sb, a.q_ss, a.q_sh, q_rows);
  if (e == 0) e = map(&tdo, a.dout, a.seq_q, do_sb, do_ss, d, q_rows);
  if (e == 0) e = map(&tk, a.k, a.seq_k, a.k_sb, a.k_ss, a.k_sh, kv_rows);
  if (e == 0) e = map(&tv, a.v, a.seq_k, a.v_sb, a.v_ss, a.v_sh, kv_rows);
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  const int seq_own = DQ ? a.seq_q : a.seq_k;
  // a cluster of NC blocks along x: block x owns row tile x / NC
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((seq_own + SL_ROWS - 1) / SL_ROWS * NC, a.heads,
                     a.batch);
  cfg.blockDim = dim3(384, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if constexpr (DQ)
    e = (int)cudaLaunchKernelEx(&cfg, kernel, tq, tdo, tk, tv, a);
  else
    e = (int)cudaLaunchKernelEx(&cfg, kernel, tk, tv, tq, tdo, a);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// the dk/dv kernel, then the dq kernel
template <int NP>
int launch_pair(const BwdArgs& a, int dev, cudaStream_t stream) {
  const int e = launch_sliced<false, NP>(a, dev, stream);
  if (e != 0) return e;
  return launch_sliced<true, NP>(a, dev, stream);
}

}  // namespace

int flash_bwd_sliced_sm90(const BwdArgs& a, int head_dim,
                          cudaStream_t stream) {
  if (head_dim < 128 || head_dim > 512 || head_dim % 64) return -2;
  const int dev = current_device();
  if (dev < 0) return -dev;
  switch (head_dim / 64) {
    case 2: return launch_pair<2>(a, dev, stream);
    case 3: return launch_pair<3>(a, dev, stream);
    case 4: return launch_pair<4>(a, dev, stream);
    case 5: return launch_pair<5>(a, dev, stream);
    case 6: return launch_pair<6>(a, dev, stream);
    case 7: return launch_pair<7>(a, dev, stream);
    default: return launch_pair<8>(a, dev, stream);
  }
}

}  // namespace vst
