// K4 in fp32 at head dims 128-512: the flash-attention backward on TF32
// wgmma at 3xTF32, D split across the blocks of a thread-block cluster
// (the "tf32x3_sliced" route of ops/flash_attention.py's `bwd_route`).
//
// Replaces, for fp32 inputs at d = 128, 192, ..., 512, the JAX package's
// Pallas kernels ops/flash_attention.py `_dqkv_kernel` / `_dq_kernel` +
// `_dkv_kernel` (launched by `_flash_bwd_bhsd`), which are generic in d.
// The path that reaches them on the card is a gradient through the SDXL
// VAE in fp32 (its mid-block attention: one head, d = 512, once per decode
// and once per encode backward).
//
// The function, per (batch, head), from the saved lse (natural log) and
// flash_attention_bwd.cu's delta = rowsum(dO * O):
//   p = exp(q k^T * scale - lse), dp = dO v^T, ds = p (dp - delta) scale,
//   dq = ds k, dk = ds^T q, dv = p^T dO,
// in fp32 to within 1e-5 + 1e-5 |plain| of `flash_attention_bwd_plain`,
// in the two-kernel form (dk/dv, then dq): no atomics, and two runs are
// bitwise equal.
//
// Bound on the H100: 14 * Sq * Sk * D flops a (batch, head) (S and dP
// formed once in each kernel) at three TF32 products a product (494.7
// TF/s dense) against ~8 * S * D * 4 bytes: the tensor cores bound it at
// every shape the route takes.
//
// Arithmetic: 3xTF32, as flash_attention_tf32.cu and geglu.cu. An fp32
// operand x is hi + lo, a product a b is a.lo b.hi + a.hi b.lo + a.hi
// b.hi, the small products first; tensor-core sums truncate, so every
// product starts from zero in the tensor core over at most 32 values of
// its contraction and is added to its running sum in f32.
//
// Design (`bwd_plan` in ops/flash_attention.py mirrors it):
//  - A cluster of NC = ceil(D / 128) blocks along the grid's x. Block
//    `rank` owns columns [128 rank, 128 rank + W) of D (W = 128, or 64 for
//    the last block where D / 64 is odd) for 64 own rows (keys for dk/dv,
//    q rows for dq); every block of a cluster has the same own rows. At d
//    = 128 the cluster is one block and nothing is exchanged.
//  - 384 threads: a producer warpgroup (24 registers) whose thread 0 keeps
//    a ring of two TMA stages full (32 streamed rows of both streamed
//    tensors a stage, the block's columns only, 128-byte swizzled panels of
//    32 fp32) and (dk/dv) whose warp 1 stages each q tile's lse and delta;
//    two consumer warpgroups (240 registers) on the same 64 own rows.
//    Consumer warpgroup 0 forms S (S^T = K Q^T for dk/dv, S = Q K^T for
//    dq), warpgroup 1 dP (dP^T = V dO^T, dP = dO V^T), so the two sums run
//    side by side.
//  - S and dP on TF32 wgmma (m64n32k8, register A): the own rows stay fp32
//    in shared memory and are split into hi and lo in registers at each k
//    step; the streamed tile, their B, is K-major as it lands (the only
//    layout TF32 wgmma reads from shared memory) and is split once: the
//    tile itself serves as hi (the tensor core reads the top 19 bits of a
//    TF32 operand) and the 256 consumer threads write lo = rna_tf32(x -
//    trunc_tf32(x)) into one lo buffer (64 threads of the producer
//    warpgroup, at its 24 registers, could not keep up: PERF.md). Per 16
//    columns of D the small products, then hi * hi, summed from zero; one
//    restart runs while the last one is added in f32 (restarts of 32
//    columns held more registers and ran slower).
//  - Each block's S and dP shares (over its W columns) are summed across
//    the cluster through distributed shared memory in two rounds, so that
//    S and dP are formed once (14 flops, nothing recomputed) and every
//    block holds the same sums bit for bit: 1. every block sends the block
//    that owns an 8-column n tile of the 32-column tile (`fs_owner`) its
//    share of that n tile, and the owner adds the NC shares in rank order;
//    2. the owner sends the sums to every other block. The sends are
//    st.async stores (a float4 a thread an n tile) into the receiving
//    warpgroup's buffer, completing on its receive barrier, as
//    flash_attention_bwd_sliced.cu's bf16 kernel does; each warpgroup
//    exchanges with its counterparts. Every block then forms P and dS of
//    the whole tile from the same sums, in the same order, so they agree
//    bit for bit; warpgroup 0 hands P to warpgroup 1 (dS = P (dP - delta)
//    scale) through shared memory.
//  - dV, dK and dQ run on TF32 wgmma too, as transposed products (option
//    ii): dV^T += dO^T P (warpgroup 0), dK^T += Q^T dS (warpgroup 1), dQ^T
//    += K^T dS^T (each warpgroup 64 of the block's columns), m64n64k8 with
//    the streamed tile as register A, read down its columns and split in
//    registers, and P^T, dS^T (dS for dq) as B: written hi and lo, K-major,
//    into shared memory once a tile. Their streamed operand is MN-major,
//    which TF32 wgmma cannot read from shared memory; transposed hi and lo
//    copies of both streamed tiles (option i) would take 64 KB more a
//    stage, and mma.sync (option iii) ran at about half the tensor rate
//    (PERF.md). Each tile's products are summed from zero and added in
//    f32; they run during the next tile's exchange (dV^T and dK^T: the
//    first 64-column chunk during its first round, the second after).
//  - Shared memory (static_asserted below, `bwd_plan` checks the same):
//    1 KB of alignment, 1 KB of barriers and (dk/dv) lse and delta rows,
//    the own rows 2 x 64 x 128 x 4 = 64 KB, two stages of 2 tensors x 32 x
//    128 x 4 = 64 KB, one lo buffer of the same 32 KB, P^T / dS^T hi and lo
//    2 x 2 x 64 x 32 x 4 = 32 KB, the exchange buffers 2 warpgroups x 6
//    slots x 2 KB = 24 KB and the P hand-off 8 KB: 231424 of the 232448
//    bytes a block may take, one block an SM.
//  - The consumer is a template on the block's rank, so that the n tiles
//    it owns, and the slots it sends and reads, are known to ptxas.
// Every TMA box starts inside its sequence, so rows past the end arrive as
// zeros; streamed columns past the end get p = ds = 0, and output rows past
// the end are not written.

#include <type_traits>

#include "common.cuh"
#include "flash_attention.cuh"
#include "mma_sync.cuh"
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

constexpr int FS_ROWS = 64;   // own rows a block: both consumer warpgroups
constexpr int FS_BN = 32;     // streamed rows a tile, both kernels
constexpr int FS_COLS = 128;  // columns of D a block, at most
constexpr int FS_NT = FS_BN / 8;  // 8-column n tiles of a streamed tile
constexpr int FS_NST = 2;     // ring stages
constexpr int FS_RS = 2;      // k steps (8 values) a tensor-core restart
constexpr uint32_t FS_OWN_PANEL = FS_ROWS * 128;  // 32 fp32 of 64 rows
constexpr uint32_t FS_STR_PANEL = FS_BN * 128;    // 32 fp32 of 32 rows
constexpr uint32_t FS_OWN_TENSOR = FS_COLS / 32 * FS_OWN_PANEL;  // 32 KB
constexpr uint32_t FS_STR_COPY = FS_COLS / 32 * FS_STR_PANEL;    // 16 KB
constexpr uint32_t FS_STAGE = 2 * FS_STR_COPY;  // both tensors: 32 KB
constexpr uint32_t FS_LO = 2 * FS_STR_COPY;     // their lo copies: 32 KB
// P^T / dS^T (dS for dq) of a tile, hi and lo, as the B operand of the
// transposed products: [2 warpgroups][hi, lo][64 rows x 32 fp32]
constexpr uint32_t FS_PB = 2 * 2 * FS_OWN_PANEL;  // 32 KB
constexpr uint32_t FS_SLOT = 128 * 16;  // a float4 a consumer thread
constexpr int FS_SLOTS = 6;             // exchange slots a warpgroup
constexpr uint32_t FS_XCH = 2 * FS_SLOTS * FS_SLOT;  // 24 KB
constexpr uint32_t FS_HAND = FS_NT * FS_SLOT;        // 8 KB
constexpr uint32_t FS_HEAD = 1024;  // barriers (128 B), lse and delta rows
constexpr long long FS_SMEM = 1024 + FS_HEAD + 2 * FS_OWN_TENSOR +
                              FS_NST * FS_STAGE + FS_LO + FS_PB + FS_XCH +
                              FS_HAND;
static_assert(128 + FS_NST * 2 * FS_BN * 4 <= FS_HEAD, "the head");
static_assert(FS_SMEM == 231424 && FS_SMEM <= 232448,
              "bwd_plan's bytes a block");

// blocks a cluster: one a 128-column slice of D
__host__ __device__ constexpr int fs_cluster(int d) { return (d + 127) / 128; }

// The block of an NC-block cluster that owns n tile j of a streamed tile:
// each block owns a run of consecutive n tiles, block r's starting at
// fs_first and fs_owned long. These are closed forms (no loop, no
// recursion), so that every use inlines and folds to a constant: a call
// left in the kernel would make ptxas ignore setmaxnreg and serialise the
// wgmmas.
__host__ __device__ __forceinline__ constexpr int fs_owner(int nc, int j) {
  return nc == 1 ? 0 : nc == 2 ? j / 2 : nc == 3 ? (j < 2 ? 0 : j - 1) : j;
}
__host__ __device__ __forceinline__ constexpr int fs_first(int nc, int r) {
  return nc == 1 ? 0 : nc == 2 ? 2 * r : nc == 3 ? (r == 0 ? 0 : r + 1) : r;
}
__host__ __device__ __forceinline__ constexpr int fs_owned(int nc, int r) {
  return nc == 1 ? 4 : nc == 2 ? 2 : nc == 3 ? (r == 0 ? 2 : 1) : 1;
}
// the n tiles before j that block r owns; j's place among its owner's;
// the n tiles before j that block r does not own
__host__ __device__ __forceinline__ constexpr int fs_before(int nc, int j,
                                                            int r) {
  return j - fs_first(nc, r) < 0 ? 0
         : j - fs_first(nc, r) > fs_owned(nc, r) ? fs_owned(nc, r)
                                                 : j - fs_first(nc, r);
}
__host__ __device__ __forceinline__ constexpr int fs_place(int nc, int j) {
  return fs_before(nc, j, fs_owner(nc, j));
}
__host__ __device__ __forceinline__ constexpr int fs_others(int nc, int r,
                                                            int j) {
  return j - fs_before(nc, j, r);
}
// block r's receive slots: round 1, from sender s its share of n tile j
// that r owns (the senders in rank order, r skipped); round 2, after
// those, the sum of n tile j that r does not own
__host__ __device__ __forceinline__ constexpr int fs_r1_slot(int nc, int s, int r, int j) {
  return (s < r ? s : s - 1) * fs_owned(nc, r) + fs_place(nc, j);
}
__host__ __device__ __forceinline__ constexpr int fs_r2_slot(int nc, int r, int j) {
  return (nc - 1) * fs_owned(nc, r) + fs_others(nc, r, j);
}
__host__ __device__ __forceinline__ constexpr int fs_slots(int nc, int r) {
  return (nc - 1) * fs_owned(nc, r) + FS_NT - fs_owned(nc, r);
}

// `bwd_plan`'s clusters, owners and slots (`exchange_slots`)
static_assert(fs_cluster(128) == 1 && fs_cluster(192) == 2 &&
                  fs_cluster(256) == 2 &&
                  fs_cluster(320) == 3 && fs_cluster(448) == 4 &&
                  fs_cluster(512) == 4,
              "bwd_plan's clusters");
static_assert(fs_owner(2, 1) == 0 && fs_owner(2, 2) == 1 &&
                  fs_owner(3, 1) == 0 && fs_owner(3, 3) == 2 &&
                  fs_owner(4, 2) == 2 && fs_place(3, 1) == 1 &&
                  fs_place(2, 3) == 1 && fs_place(4, 3) == 0,
              "one owner an n tile");
static_assert(fs_slots(2, 0) == 4 && fs_slots(3, 0) == 6 &&
                  fs_slots(3, 2) == 5 && fs_slots(4, 3) == 6 &&
                  fs_r1_slot(3, 2, 0, 1) == 3 && fs_r2_slot(3, 1, 3) == 4 &&
                  fs_r2_slot(4, 0, 1) == 3 && fs_r1_slot(4, 0, 3, 3) == 0,
              "bwd_plan's exchange slots");
static_assert(FS_NT == 4 && FS_BN % 8 == 0, "four n tiles a streamed tile");
static_assert(fs_owner(2, 3) == 1 && fs_owned(3, 0) == 2 &&
                  fs_first(3, 2) == 3 && fs_owned(4, 2) == 1 &&
                  fs_before(4, 4, 3) == 1 && fs_before(2, 4, 0) == 2 &&
                  fs_before(3, 2, 1) == 0 && fs_before(3, 4, 1) == 1,
              "each block's run of n tiles");

// the lo part of an fp32 value whose hi is its top 19 bits (TF32
// truncated, as the tensor core reads the value): x - hi exactly, rounded
// to TF32
__device__ __forceinline__ float fs_lo(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float(rna_tf32(__float_as_uint(x - hi)));
}

struct FsSmem {
  uint64_t* bar_own;
  uint64_t* full;     // [stage] the streamed tiles landed (and, dk/dv, rows)
  uint64_t* empty;    // [stage] the streamed tiles read
  uint64_t* xa;  // [2] round 1: the other blocks' shares received
  uint64_t* xb;  // [2] round 2: the other blocks' sums received
  const float* rows;   // [stage][lse (log2 units), delta][FS_BN] (dk/dv)
  unsigned char* own;  // [2 tensors][4 panels][64 rows]
  unsigned char* ring;  // [stage][2 tensors][4 panels][32 rows]
  unsigned char* lo;    // [2 tensors][4 panels][32 rows]
  unsigned char* pb;    // [2 warpgroups][hi, lo][64 rows x 32 fp32]
  unsigned char* xch;   // [2 warpgroups][FS_SLOTS][128 threads] float4
  float4* hand;         // [FS_NT][128 threads]: P
};

// A consumer warpgroup of block RANK. DQ = false: the dk/dv kernel (own K,
// V; streams Q, dO; S^T = K Q^T, dP^T = V dO^T; dV^T += dO^T P and dK^T
// += Q^T dS). DQ = true: the dq kernel (own Q, dO; streams K, V; S = Q
// K^T, dP = dO V^T; dQ^T += K^T dS^T). Warpgroup c (0: S, 1: dP) takes own
// tensor c and streamed tensor c for its share.
template <bool DQ, int D, int RANK>
__device__ __forceinline__ void fs_consumer(const FsSmem& sm,
                                            const BwdArgs& a, int r0, int h,
                                            int b) {
  constexpr int NC = fs_cluster(D);
  constexpr int C0 = FS_COLS * RANK;  // the block's first column of D
  constexpr int W = D - C0 < FS_COLS ? D - C0 : FS_COLS;  // and its width
  constexpr int KS = W / 8;       // k steps of a share
  constexpr int NR = KS / FS_RS;  // restarts of a share
  // 64-column chunks of D this warpgroup's transposed output takes: dV^T
  // or dK^T all of the block's; dQ^T half (at W = 64 warpgroup 0 all)
  constexpr int NM = DQ ? 1 : W / 64;
  // a cluster of one block (d = 128) exchanges nothing
  constexpr bool XCH = NC > 1 && VST_K4_CUTOUT != 3;
  constexpr int OWNED = fs_owned(NC, RANK);
  constexpr uint32_t R1_TX = (NC - 1) * OWNED * FS_SLOT;
  constexpr uint32_t R2_TX = (FS_NT - OWNED) * FS_SLOT;
  static_assert(W % 64 == 0 && KS % FS_RS == 0 && NR >= 2, "slices");
  static_assert(fs_slots(NC, RANK) <= FS_SLOTS, "exchange slots");
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int rl = 16 * warp + g;  // this thread's own rows rl, rl + 8
  const int row0 = r0 + rl;
  const float sl2 = a.scale * kLog2e;
  const long long bh = ((long long)b * a.heads + h) * a.seq_q;
  const int seq_own = DQ ? a.seq_q : a.seq_k;
  const int seq_str = DQ ? a.seq_k : a.seq_q;
  const int nt = (seq_str + FS_BN - 1) / FS_BN;
  const unsigned char* own = sm.own + c * FS_OWN_TENSOR;
  const float4* xbuf = reinterpret_cast<const float4*>(
                           sm.xch + c * FS_SLOTS * FS_SLOT) + tid;
  const uint32_t x_addr = smem_u32(xbuf);
  const uint32_t xa_addr = smem_u32(&sm.xa[c]), xb_addr = smem_u32(&sm.xb[c]);
  // the transposed products: A the streamed tensor `ya` read down its
  // columns (dO for dV^T, Q for dK^T, K for dQ^T), from chunk m0 on; B the
  // P^T / dS^T / dS tile in pb[pbw]
  const int ya = DQ ? 0 : 1 - c;
  const int m0 = DQ && W == 128 ? c : 0;
  unsigned char* pbw = sm.pb + (DQ ? 1 : c) * 2 * FS_OWN_PANEL;
  const uint32_t pb_addr = smem_u32(pbw);
  // dq at W = 64: both warpgroups run the one chunk's product (no wgmma
  // depends on the warpgroup), warpgroup 0 stores it
  const bool stores = !DQ || W == 128 || c == 0;

  // the transposed output: NM m64n64 accumulators
  float acc[NM][32];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  // dq: lse (log2 units) and delta of this thread's rows
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};
  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row0 + 8 * r < a.seq_q;
      lr[r] = ok ? a.lse[bh + row0 + 8 * r] * kLog2e : 0.f;
      dr[r] = ok ? a.delta[bh + row0 + 8 * r] : 0.f;
    }
  }

  // Lane offsets into the 128-byte swizzled panels (row r, column c at
  // panel c / 32, byte r * 128 + ((c / 4 % 8) ^ (r % 8)) * 16 + c % 4 * 4),
  // so that every fragment load and store below is a register plus an
  // immediate (computed where used: held, they cost registers the
  // products need).
  // - aoff(kk % 4, e): the share's A, own row rl, column 8 kk + t4 + 4 e
  //   (+ panel kk / 4; + 1024 for row rl + 8).
  // - coff(e, f): the products' A, streamed row 8 kk + t4 + 4 f, column
  //   16 warp + g + 8 e of a 64-column chunk (+ 2 panels a chunk; + 1024
  //   kk).
  // - poff(j): P^T / dS^T / dS into pb, own row rl, columns 8 j + 2 t4
  //   and + 1 (+ 1024 for row rl + 8).
  auto aoff = [&](int m, int e) -> uint32_t {
    return rl * 128 + (((2 * m + e) ^ g) << 4) + t4 * 4;
  };
  auto coff = [&](int e, int f) -> uint32_t {
    return (warp >> 1) * FS_STR_PANEL + (t4 + 4 * f) * 128 +
           (((4 * (warp & 1) + 2 * e + (g >> 2)) ^ (t4 + 4 * f)) << 4) +
           (g & 3) * 4;
  };
  auto poff = [&](int j) -> uint32_t {
    return rl * 128 + (((2 * j + (t4 >> 1)) ^ g) << 4) + (t4 & 1) * 8;
  };
  auto ld = [](const unsigned char* base, uint32_t off) {
    return *reinterpret_cast<const float*>(base + off);
  };
  // the share's A fragments (hi, lo) of k step kk: own rows rl, rl + 8,
  // columns 8 kk + t4 and 8 kk + t4 + 4 of the slice
  auto load_a = [&](uint32_t (&hi)[4], uint32_t (&lo)[4], int kk) {
    const unsigned char* p = own + (kk >> 2) * FS_OWN_PANEL;
    split(ld(p, aoff(kk & 3, 0)), hi[0], lo[0]);
    split(ld(p + 1024, aoff(kk & 3, 0)), hi[1], lo[1]);
    split(ld(p, aoff(kk & 3, 1)), hi[2], lo[2]);
    split(ld(p + 1024, aoff(kk & 3, 1)), hi[3], lo[3]);
  };
  // Issues chunk m's product of a tile: acc[m] += Y^T W over the tile's 32
  // streamed rows (A: columns 64 (m0 + m) .. of the tile's streamed tensor
  // ya, split in registers; B: pb, hi and lo), its products summed from
  // zero into `pr` (the small ones first), which the caller waits for and
  // adds. The A fragments are read before this returns.
  auto issue_product = [&](float* pr, const unsigned char* stage, int m) {
    const unsigned char* y =
        stage + ya * FS_STR_COPY + 2 * (m0 + m) * FS_STR_PANEL;
    uint32_t phi[FS_NT][4], plo[FS_NT][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) pr[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < FS_NT; ++kk) {
      const unsigned char* p = y + 1024 * kk;
      split(ld(p, coff(0, 0)), phi[kk][0], plo[kk][0]);
      split(ld(p, coff(1, 0)), phi[kk][1], plo[kk][1]);
      split(ld(p, coff(0, 1)), phi[kk][2], plo[kk][2]);
      split(ld(p, coff(1, 1)), phi[kk][3], plo[kk][3]);
    }
    fence_regs<32>(pr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FS_NT; ++kk) {
      wgmma_tf32_rs64(pr, plo[kk], desc_kmajor(pb_addr, 0, kk), kk > 0);
      wgmma_tf32_rs64(pr, phi[kk],
                      desc_kmajor(pb_addr + FS_OWN_PANEL, 0, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < FS_NT; ++kk)
      wgmma_tf32_rs64(pr, phi[kk], desc_kmajor(pb_addr, 0, kk), 1);
    wgmma_commit();
  };
  auto add_product = [&](float* pr, int m) {
    wgmma_wait<0>();
    fence_regs<32>(pr);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] += pr[i];
  };
  // a stage back to the producer, once every warp has read it
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  };
  // P^T, dS^T or dS (sh) of a tile, hi and lo, into pb: own rows by 32
  // streamed columns, the B operand (K-major) of the tile's products
  auto store_pb = [&](const float (&sh)[4 * FS_NT]) {
#pragma unroll
    for (int j = 0; j < FS_NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t hi0, lo0, hi1, lo1;
        split(sh[4 * j + 2 * r], hi0, lo0);
        split(sh[4 * j + 2 * r + 1], hi1, lo1);
        *reinterpret_cast<uint2*>(pbw + poff(j) + 1024 * r) =
            make_uint2(hi0, hi1);
        *reinterpret_cast<uint2*>(pbw + FS_OWN_PANEL + poff(j) + 1024 * r) =
            make_uint2(lo0, lo1);
      }
    fence_proxy_async();  // to the wgmmas that read them
  };

  // tile t; with PROD, the last tile's products run in its exchange's gaps
  // (a wgmma issued and waited for inside one branch of a runtime
  // condition would be serialised, so the first tile is a call of its own)
  auto tile = [&](auto prod_flag, int t) {
    constexpr bool PROD = decltype(prod_flag)::value;
    const int st = t % FS_NST;
    // the last tile's products (two accumulators, one for dq) and two
    // restarts of the share, defined here and set where they are first
    // used (the wgmmas read and write them), so that none stays live
    // longer than its products
    float prod[NM][32], part[2][4 * FS_NT];
#pragma unroll
    for (int i = 0; i < 4 * FS_NT; ++i) part[0][i] = part[1][i] = 0.f;
    const unsigned char* stage = sm.ring + st * FS_STAGE;
    const unsigned char* last = sm.ring + (st ^ 1) * FS_STAGE;
    mbar_wait(&sm.full[st], (t / FS_NST) & 1);
#if VST_K4_CUTOUT == 1
    release(st);
    return;
#endif
    // the tile's lo copies, by the 256 consumer threads (both warpgroups
    // have formed the last tile's shares: the P hand-off's barriers order
    // them)
    {
      const int n4 = W / 32 * FS_STR_PANEL / 16;  // float4s a tensor
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const float4* src =
            reinterpret_cast<const float4*>(stage + y * FS_STR_COPY);
        float4* dst = reinterpret_cast<float4*>(sm.lo + y * FS_STR_COPY);
#pragma unroll
        for (int k = 0; k < n4 / 256; ++k) {
          const int i = 256 * k + (int)threadIdx.x - 128;
          const float4 v = src[i];
          dst[i] = make_float4(fs_lo(v.x), fs_lo(v.y), fs_lo(v.z), fs_lo(v.w));
        }
      }
      fence_proxy_async();  // the copies, to the wgmmas that read them
      named_sync(1, 256);
    }
    if (XCH && tid == 0) {
      // this tile's phases of the receive barriers: the last tile's are
      // complete (waited), and what arrives early counts below zero
      mbar_arrive_tx(&sm.xa[c], R1_TX);
      mbar_arrive_tx(&sm.xb[c], R2_TX);
    }

    // this warpgroup's share of S (S^T) or dP (dP^T) over the block's
    // columns: restarts of FS_RS k steps, each summed from zero (its small
    // products first) into one of two accumulators and added in f32, in
    // order; one restart runs while the last one is added and the next
    // one's A fragments load
    const uint32_t yhi = smem_u32(stage) + c * FS_STR_COPY;
    const uint32_t ylo = smem_u32(sm.lo) + c * FS_STR_COPY;
    float sh[4 * FS_NT];
    {
      uint32_t ahi[2][FS_RS][4], alo[2][FS_RS][4];
#pragma unroll
      for (int kk = 0; kk < FS_RS; ++kk) load_a(ahi[0][kk], alo[0][kk], kk);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int k0 = r * FS_RS;
        float* pr = part[r & 1];
        fence_regs<4 * FS_NT>(pr);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FS_RS; ++kk) {
          wgmma_tf32_rs32(pr, alo[r & 1][kk],
                          desc_kmajor(yhi, FS_STR_PANEL, k0 + kk), kk > 0);
          wgmma_tf32_rs32(pr, ahi[r & 1][kk],
                          desc_kmajor(ylo, FS_STR_PANEL, k0 + kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < FS_RS; ++kk)
          wgmma_tf32_rs32(pr, ahi[r & 1][kk],
                          desc_kmajor(yhi, FS_STR_PANEL, k0 + kk), 1);
        wgmma_commit();
        if (r > 0) {
          // restart r - 1 is done: its sum, then its A fragments'
          // registers take restart r + 1's
          wgmma_wait<1>();
          float* pl = part[(r - 1) & 1];
          fence_regs<4 * FS_NT>(pl);
#pragma unroll
          for (int i = 0; i < 4 * FS_NT; ++i)
            sh[i] = r == 1 ? pl[i] : sh[i] + pl[i];
        }
        if (r + 1 < NR) {
#pragma unroll
          for (int kk = 0; kk < FS_RS; ++kk)
            load_a(ahi[(r + 1) & 1][kk], alo[(r + 1) & 1][kk],
                   k0 + FS_RS + kk);
        }
      }
      wgmma_wait<0>();
      float* pl = part[(NR - 1) & 1];
      fence_regs<4 * FS_NT>(pl);
#pragma unroll
      for (int i = 0; i < 4 * FS_NT; ++i) sh[i] += pl[i];
    }

    // the exchange's two rounds; the last tile's products run in its gaps
    if constexpr (XCH) {
      // round 1: each other block's n tiles, to it
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        if (r == RANK) continue;
        const uint32_t bar = mapa(xa_addr, r);
#pragma unroll
        for (int j = 0; j < FS_NT; ++j) {
          if (fs_owner(NC, j) != r) continue;
          st_async_f4(mapa(x_addr + fs_r1_slot(NC, RANK, r, j) * FS_SLOT, r),
                      make_float4(sh[4 * j], sh[4 * j + 1], sh[4 * j + 2],
                                  sh[4 * j + 3]),
                      bar);
        }
      }
    }
    if constexpr (PROD) {
      issue_product(prod[0], last, 0);
      if constexpr (NM == 1) release(st ^ 1);
    }
    if constexpr (XCH) {
      // the owned n tiles' shares summed in rank order
      mbar_wait_cluster(&sm.xa[c], t & 1);
#pragma unroll
      for (int j = 0; j < FS_NT; ++j) {
        if (fs_owner(NC, j) != RANK) continue;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < NC; ++r) {
          const float4 v =
              r == RANK ? make_float4(sh[4 * j], sh[4 * j + 1], sh[4 * j + 2],
                                      sh[4 * j + 3])
                        : xbuf[fs_r1_slot(NC, r, RANK, j) * 128];
          if (r == 0) {
            sum = v;
          } else {
            sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
          }
        }
        sh[4 * j] = sum.x, sh[4 * j + 1] = sum.y, sh[4 * j + 2] = sum.z,
        sh[4 * j + 3] = sum.w;
      }
      // round 2: the owned n tiles' sums, to every other block
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        if (r == RANK) continue;
        const uint32_t bar = mapa(xb_addr, r);
#pragma unroll
        for (int j = 0; j < FS_NT; ++j) {
          if (fs_owner(NC, j) != RANK) continue;
          st_async_f4(mapa(x_addr + fs_r2_slot(NC, r, j) * FS_SLOT, r),
                      make_float4(sh[4 * j], sh[4 * j + 1], sh[4 * j + 2],
                                  sh[4 * j + 3]),
                      bar);
        }
      }
    }
    if constexpr (PROD) {
      add_product(prod[0], 0);
    }
    if constexpr (XCH) {
      // the other n tiles' sums from their owners
      mbar_wait_cluster(&sm.xb[c], t & 1);
#pragma unroll
      for (int j = 0; j < FS_NT; ++j) {
        if (fs_owner(NC, j) == RANK) continue;
        const float4 v = xbuf[fs_r2_slot(NC, RANK, j) * 128];
        sh[4 * j] = v.x, sh[4 * j + 1] = v.y, sh[4 * j + 2] = v.z,
        sh[4 * j + 3] = v.w;
      }
    }
    if constexpr (PROD && NM == 2) {
      // the second chunk after the second round, waited for at once
      // (issued during the round, or left running during P and dS, its
      // registers pushed dk/dv kernels into spills)
      issue_product(prod[1], last, 1);
      release(st ^ 1);
      add_product(prod[1], 1);
    }

    // P (warpgroup 0), handed to warpgroup 1, which forms dS; streamed
    // columns at or past the end: 0. Each into pb for its products (dq:
    // dS alone, which both warpgroups read)
    const int left = seq_str - t * FS_BN;
    const float* rw = sm.rows + st * 2 * FS_BN;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < FS_NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const float l = DQ ? lr[e >> 1] : rw[col];
          sh[4 * j + e] =
              col < left ? exp2f(fmaf(sh[4 * j + e], sl2, -l)) : 0.f;
        }
        sm.hand[j * 128 + tid] = make_float4(sh[4 * j], sh[4 * j + 1],
                                             sh[4 * j + 2], sh[4 * j + 3]);
      }
      named_arrive(2, 256);
      if constexpr (!DQ) {
        store_pb(sh);
        named_sync(4, 128);
      }
      // warpgroup 1 has read P (dq: and written dS to pb)
      named_sync(3, 256);
    } else {
      named_sync(2, 256);
#pragma unroll
      for (int j = 0; j < FS_NT; ++j) {
        const float4 p = sm.hand[j * 128 + tid];
        if constexpr (!DQ) {
          if (j == FS_NT - 1) named_arrive(3, 256);  // P read
        }
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const float dl = DQ ? dr[e >> 1] : rw[FS_BN + col];
          sh[4 * j + e] =
              col < left ? pv[e] * (sh[4 * j + e] - dl) * a.scale : 0.f;
        }
      }
      store_pb(sh);
      if constexpr (DQ) {
        named_sync(3, 256);  // dS in pb, for both warpgroups
      } else {
        named_sync(5, 128);
      }
    }
  };

  mbar_wait(sm.bar_own, 0);
  tile(std::false_type(), 0);
  for (int t = 1; t < nt; ++t) tile(std::true_type(), t);
#if VST_K4_CUTOUT != 1
  {
    // the last tile's products (nt >= 1: the wrapper refuses empty
    // sequences)
    const int st = (nt - 1) % FS_NST;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float prod[32];
      issue_product(prod, sm.ring + st * FS_STAGE, m);
      add_product(prod, m);
    }
    release(st);
  }
#endif

  // this warpgroup's transposed output: accumulator row 16 warp + g (+ 8)
  // of chunk m is column C0 + 64 (m0 + m) + .. of D, its column 8 i + 2 t4
  // (+ 1) an own row
  if (!stores) return;
  float* out = static_cast<float*>(DQ ? a.dq : c == 0 ? a.dv : a.dk);
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * i + 2 * t4 + (e & 1);
        if (row >= seq_own) continue;
        out[(((long long)b * seq_own + row) * a.heads + h) * D + C0 +
            64 * (m0 + m) + 16 * warp + g + 8 * (e >> 1)] = acc[m][4 * i + e];
      }
}

// The consumer of block `rank`, its rank made a template argument.
template <bool DQ, int D>
__device__ __forceinline__ void fs_consumers(const FsSmem& sm,
                                             const BwdArgs& a, int r0, int h,
                                             int b, int rank) {
  constexpr int NC = fs_cluster(D);
  if (rank == 0) {
    fs_consumer<DQ, D, 0>(sm, a, r0, h, b);
  } else if constexpr (NC > 1) {
    if (rank == 1) {
      fs_consumer<DQ, D, 1>(sm, a, r0, h, b);
    } else if constexpr (NC > 2) {
      if (rank == 2) {
        fs_consumer<DQ, D, 2>(sm, a, r0, h, b);
      } else if constexpr (NC > 3) {
        fs_consumer<DQ, D, 3>(sm, a, r0, h, b);
      }
    }
  }
}

// D is a template argument so that every walk over panels, k steps and n
// tiles unrolls (a runtime walk would carry wgmma accumulators across a
// loop's back edge).
template <bool DQ, int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_sliced_tf32_kernel(const __grid_constant__ CUtensorMap t_own0,
                                 const __grid_constant__ CUtensorMap t_own1,
                                 const __grid_constant__ CUtensorMap t_str0,
                                 const __grid_constant__ CUtensorMap t_str1,
                                 const BwdArgs a) {
  constexpr int NC = fs_cluster(D);
  static_assert(D % 64 == 0 && D >= 128 && D <= 512, "head dim");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  FsSmem sm;
  sm.bar_own = reinterpret_cast<uint64_t*>(smem);
  sm.full = sm.bar_own + 1;
  sm.empty = sm.full + FS_NST;
  sm.xa = sm.empty + FS_NST;
  sm.xb = sm.xa + 2;
  float* rows = reinterpret_cast<float*>(smem + 128);
  sm.rows = rows;
  sm.own = smem + FS_HEAD;
  sm.ring = sm.own + 2 * FS_OWN_TENSOR;
  sm.lo = sm.ring + FS_NST * FS_STAGE;
  sm.pb = sm.lo + FS_LO;
  sm.xch = sm.pb + FS_PB;
  sm.hand = reinterpret_cast<float4*>(sm.xch + FS_XCH);

  const int wg = threadIdx.x / 128;
  const int rank = (int)cluster_ctarank();
  const int r0 = blockIdx.x / NC * FS_ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = FS_COLS * rank;              // the block's columns
  const int np = min(FS_COLS, D - c0) / 32;   // and their panels
  const int seq_str = DQ ? a.seq_k : a.seq_q;
  const int nt = (seq_str + FS_BN - 1) / FS_BN;

  if (threadIdx.x == 0) {
    mbar_init(sm.bar_own, 1);
    for (int i = 0; i < FS_NST; ++i) {
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
  cluster_sync();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    // 24 + 2 x 240 registers a thread of each warpgroup: the 65536 of the
    // SM (what the producer frees is what the consumers take)
    setmaxnreg_dec<24>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_arrive_tx(sm.bar_own, 2 * np * FS_OWN_PANEL);
      for (int p = 0; p < np; ++p) {
        tma_load_4d(sm.own + p * FS_OWN_PANEL, &t_own0, sm.bar_own,
                    c0 + 32 * p, h, r0, b);
        tma_load_4d(sm.own + FS_OWN_TENSOR + p * FS_OWN_PANEL, &t_own1,
                    sm.bar_own, c0 + 32 * p, h, r0, b);
      }
      for (int t = 0; t < nt; ++t) {
        const int st = t % FS_NST;
        const int row = VST_K4_CUTOUT == 2 ? 0 : t * FS_BN;
        mbar_wait(&sm.empty[st], ((t / FS_NST) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[st], 2 * np * FS_STR_PANEL);
        unsigned char* s = sm.ring + st * FS_STAGE;
        for (int p = 0; p < np; ++p) {
          tma_load_4d(s + p * FS_STR_PANEL, &t_str0, &sm.full[st],
                      c0 + 32 * p, h, row, b);
          tma_load_4d(s + FS_STR_COPY + p * FS_STR_PANEL, &t_str1,
                      &sm.full[st], c0 + 32 * p, h, row, b);
        }
      }
    } else if (!DQ && warp == 1) {
      // lse (log2 units) and delta of each q tile's rows; zero past Sq
      const long long bh = ((long long)b * a.heads + h) * a.seq_q;
      for (int t = 0; t < nt; ++t) {
        const int st = t % FS_NST;
        mbar_wait(&sm.empty[st], ((t / FS_NST) & 1) ^ 1);
        float* rw = rows + st * 2 * FS_BN;
        const int q = t * FS_BN + lane;
        const bool ok = q < a.seq_q;
        rw[lane] = ok ? a.lse[bh + q] * kLog2e : 0.f;
        rw[FS_BN + lane] = ok ? a.delta[bh + q] : 0.f;
        mbar_arrive(&sm.full[st]);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    setmaxnreg_inc<240>();
    fs_consumers<DQ, D>(sm, a, r0, h, b, rank);
  }
  // no block leaves while another may still read or write its shared
  // memory
  cluster_sync();
}

template <bool DQ, int D>
int launch_fs(const BwdArgs& a, int dev, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr int NC = fs_cluster(D);
  auto kernel = flash_bwd_sliced_tf32_kernel<DQ, D>;
  int e = allow_smem_once(kernel, (int)FS_SMEM, dev, smem_set);
  if (e != 0) return e;
  // 4-D (D, H, S, B) maps of the strided views, boxes of one 32-wide
  // panel by the own (64) or streamed (32) rows
  auto map = [&](CUtensorMap* t, const void* p, int seq, long long sb,
                 long long ss, long long sh, int rows) {
    return cached_bshd_tensor_map(t, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p,
                                  a.batch, seq, a.heads, D, sb, ss, sh, 32,
                                  rows, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const long long do_ss = (long long)a.heads * D;
  const long long do_sb = (long long)a.seq_q * do_ss;
  const int q_rows = DQ ? FS_ROWS : FS_BN, kv_rows = DQ ? FS_BN : FS_ROWS;
  CUtensorMap tq, tdo, tk, tv;
  e = map(&tq, a.q, a.seq_q, a.q_sb, a.q_ss, a.q_sh, q_rows);
  if (e == 0) e = map(&tdo, a.dout, a.seq_q, do_sb, do_ss, D, q_rows);
  if (e == 0) e = map(&tk, a.k, a.seq_k, a.k_sb, a.k_ss, a.k_sh, kv_rows);
  if (e == 0) e = map(&tv, a.v, a.seq_k, a.v_sb, a.v_ss, a.v_sh, kv_rows);
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  const int seq_own = DQ ? a.seq_q : a.seq_k;
  // a cluster of NC blocks along x: block x owns row tile x / NC
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((seq_own + FS_ROWS - 1) / FS_ROWS * NC, a.heads,
                     a.batch);
  cfg.blockDim = dim3(384, 1, 1);
  cfg.dynamicSmemBytes = (size_t)FS_SMEM;
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
template <int D>
int launch_fs_pair(const BwdArgs& a, int dev, cudaStream_t stream) {
  const int e = launch_fs<false, D>(a, dev, stream);
  if (e != 0) return e;
  return launch_fs<true, D>(a, dev, stream);
}

}  // namespace

int flash_bwd_sliced_tf32(const BwdArgs& a, int head_dim,
                          cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return -dev;
  switch (head_dim) {
    case 128: return launch_fs_pair<128>(a, dev, stream);
    case 192: return launch_fs_pair<192>(a, dev, stream);
    case 256: return launch_fs_pair<256>(a, dev, stream);
    case 320: return launch_fs_pair<320>(a, dev, stream);
    case 384: return launch_fs_pair<384>(a, dev, stream);
    case 448: return launch_fs_pair<448>(a, dev, stream);
    case 512: return launch_fs_pair<512>(a, dev, stream);
    default: return -2;
  }
}

}  // namespace vst
