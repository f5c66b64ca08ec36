// K1 and K4 in fp32 at head_dim 64: flash-attention forward and backward
// on Hopper's tensor cores at 3xTF32 (the "tf32x3" route of
// ops/flash_attention.py's `route` and `bwd_route`; K4 in fp32 at head
// dims 128-512 is flash_attention_bwd_sliced_tf32.cu's).
//
// Replaces, for fp32 inputs, the JAX package's Pallas kernels
// ops/flash_attention.py `_attn_kernel_packed_single` /
// `_attn_kernel_packed` (K1, launched by `_flash_fwd_bs_hd` and
// `_flash_fwd_qkv_packed`) and `_dqkv_kernel` / `_dq_kernel` +
// `_dkv_kernel` (K4, launched by `_flash_bwd_bhsd`). Every SDXL
// self-attention has d = 64; fp32 runs them under --mixed_precision no
// (serving and stage 2) and in the card-vs-CPU reference steps.
//
// Same functions as the bf16 routes, per (batch, head):
//   forward:  out = softmax(q k^T * scale) v, lse in natural-log units;
//   backward: p = exp(q k^T * scale - lse) from the saved lse,
//             dp = dO v^T, ds = p (dp - delta) scale,
//             dq = ds k, dk = ds^T q, dv = p^T dO,
// with delta = rowsum(dO * O) from flash_attention_bwd.cu's delta kernel.
// q, k, v are (B, S, H, D) strided views (the fused (B, S, 3*H*D)
// projection read in place); out and dO are (B, Sq, H*D) contiguous, lse
// and delta (B, H, Sq) f32; dq, dk, dv are written (B, S, H, D)
// contiguous. The kv tail (forward, dq) and the q tail (dk/dv) are
// masked; rows past the end are zero-filled and never written.
//
// Arithmetic: 3xTF32 on mma.sync.m16n8k8.tf32. Each fp32 operand x
// splits into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (TF32 to
// nearest, ties away, as cvt.rna rounds, in two integer ops); a
// product takes lo*hi and hi*lo into the f32 accumulator first, then
// hi*hi (CUTLASS's OpMultiplyAddFastF32 order). The dropped lo*lo and the
// rounding of lo leave ~2^-21 of each product, a small factor above fp32
// rounding; the fp32 tolerances hold unchanged. Tensor-core accumulation
// truncates, so no accumulator takes a long sum there: every product over
// a 64-wide tile starts from zero in the tensor core (8 k-steps, 24
// mma), and the running O, dK, dV and dQ take each tile's sum with a
// rounded FADD in registers. S^T = K Q^T (dk/dv) runs the same products in
// the same order as S = Q K^T (forward, dq), operand roles swapped, so the
// backward recomputes the forward's S bit for bit and p <= 1 holds as in
// JAX's `_recompute_p_ds`.
//
// Bound on the H100: the forward does 4, the two backward kernels 14 *
// Sq * Sk * D flops a (batch, head) against ~4 and ~8 * S * D * 4 bytes:
// at 3 tensor products a product, the TF32 rate (494.7 TF/s dense) bounds
// both, ~2.5x the FP32 FMA rate that an exact fp32 kernel is held to.
//
// Why mma.sync and not wgmma: tf32 wgmma takes only K-major A and B. P V
// needs V K-major, and dV = P^T dO, dK = dS^T Q and dQ = dS K all need B
// with their rows contiguous; TMA cannot transpose fp32, so each would
// need a transposed hi and lo copy in shared memory, which does not fit
// beside a double-buffered tile at d = 64. mma.sync fragments load from
// any layout of a padded fp32 tile.
//
// Design (FA2's register layout, Ampere-style loads):
// - 4 warps, each owning 16 rows of a 64-row tile (BT); the other side of
//   each product streams through shared memory in 64-row tiles (BS),
//   double buffered by cp.async (zero-fill past the sequence's end): each
//   tile crosses HBM once a block and loads while the one before is
//   computed, one block-wide barrier a tile.
// - Tiles are row-major with rows of D + 4 floats, so every fragment load
//   is free of bank conflicts: a B fragment read along a row (K in S = Q
//   K^T) or down a column (V in P V) puts the 32 lanes on 32 banks.
// - S, P, dP and dS stay in registers. An m16n8 accumulator's columns
//   (2t, 2t + 1) are not the k slots (t, t + 4) of an m16n8k8 A fragment;
//   the k order of the product that consumes it is permuted instead
//   (slot t takes key 2t, slot t + 4 key 2t + 1), in the A fragment and
//   in the B rows alike, so P and dS become A fragments where they are
//   made. Operands loaded from shared memory are split as each fragment
//   is loaded; P and dS are split in registers.
// - Forward: this lane's Q values stay in registers for the whole kv
//   walk, split at each use; online softmax in log2 units on the rows each
//   quad of lanes shares; O (16 x 64 a warp) in registers.
// - Backward, the two-kernel form (no atomics, deterministic): the dk/dv
//   kernel owns 64 keys and walks the q tiles with their lse and delta,
//   computing S^T = K Q^T and dP^T = V dO^T so that P^T and dS^T come out
//   as the A fragments of dV += P^T dO and dK += dS^T Q; the dq kernel
//   owns 64 q rows and walks the kv tiles: S = Q K^T, dP = dO V^T, dQ +=
//   dS K.
// - 128 threads, 203-252 registers and 68-104 KB of shared memory a
//   block: two blocks an SM. On an H100 the kernels stay well below what
//   mma.sync TF32 can issue; neither leaving lo's rounding to the tensor
//   core, nor a third block an SM (32-row streamed tiles), nor the split
//   in FP ops moved that (PERF.md, section 6).

#include <atomic>

#include "common.cuh"
#include "flash_attention.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"

namespace vst {
namespace {

using sm90::smem_u32;

constexpr int D = 64;         // head dim
constexpr int BT = 64;        // rows a block owns: q rows, or keys (dk/dv)
constexpr int BS = 64;        // rows a streamed tile: keys, or q rows (dk/dv)
constexpr int MIN_BLOCKS = 2;  // blocks an SM the registers are cut to
constexpr int LD = D + 4;     // floats a row of a shared tile
constexpr int TILE = BT * LD;    // floats an owned tile
constexpr int STILE = BS * LD;   // floats a streamed tile
constexpr int THREADS = 128;  // 4 warps of 16 rows
constexpr int NS = BS / 8;    // 8-wide n tiles across a streamed tile
constexpr int KS = D / 8;     // k steps of a product over d
// forward: two K and two V stages (Q staged through the V stages); dk/dv:
// K, V, two Q and two dO stages and each q tile's lse and delta; dq: Q,
// dO, two K and two V stages
constexpr size_t SMEM_FWD = 4 * STILE * sizeof(float);
constexpr size_t SMEM_DKV = (2 * TILE + 4 * STILE + 4 * BS) * sizeof(float);
constexpr size_t SMEM_DQ = (2 * TILE + 4 * STILE) * sizeof(float);
static_assert(2 * BS >= BT, "Q fits the forward's two V stages");
static_assert(MIN_BLOCKS * (SMEM_DKV + 1024) <= 233472,
              "MIN_BLOCKS blocks an SM");
static_assert((LD * sizeof(float)) % 16 == 0, "16-byte cp.async rows");

// ---------------------------------------------------------------- 3xTF32

// A = X[r0 .. r0 + 16)[k0 .. k0 + 8) of a shared tile, k slot j = column
// k0 + j
__device__ __forceinline__ void load_a(FragA& f, const float* X, int r0,
                                       int k0, int g, int t) {
  const float* p = X + (r0 + g) * LD + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * LD], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * LD + 4], f.hi[3], f.lo[3]);
}

// B[k][n] = Y[n0 + n][k0 + k] (a tile read along its rows), k slot j =
// column k0 + j: lanes on banks 4g + t
__device__ __forceinline__ void load_bt(FragB& f, const float* Y, int n0,
                                        int k0, int g, int t) {
  const float* p = Y + (n0 + g) * LD + k0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// B[k][n] = Y[k0 + k][n0 + n] (a tile read down its columns) in acc_to_a's
// k order, slot t = row 2t, slot t + 4 = row 2t + 1: lanes on banks 8t + g
// and 8t + 4 + g
__device__ __forceinline__ void load_b(FragB& f, const float* Y, int k0,
                                       int n0, int g, int t) {
  const float* p = Y + (k0 + 2 * t) * LD + n0 + g;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[LD], f.hi[1], f.lo[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + ROWS) of a (rows, D) fp32 matrix of row stride `stride`
// (elements) -> a shared tile; rows at or past `nrows` are zero-filled
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int r0,
                                          int nrows) {
  static_assert(ROWS * D / 4 % THREADS == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * D / 4 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * LD + c,
               src + (ok ? (long long)(r0 + r) * stride + c : 0), ok);
  }
}

// rows row0 and row0 + 8 of a warp's (16, D) f32 accumulator (scaled by
// inv[r]) -> a contiguous row-major output of `row_stride` floats a row
__device__ __forceinline__ void store_rows(float* out, long long row_stride,
                                           const float (&acc)[D / 8][4],
                                           int row0, int nrows, int t,
                                           const float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrows) continue;
    float* o = out + (long long)row * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

// --------------------------------------------------------------- forward

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_fwd_tf32_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [2] K tiles
  float* Vs = smem + 2 * STILE;  // [2] V tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's rows of the q tile
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int n_tiles = (a.seq_k + BS - 1) / BS;

  // Q passes through the two V stages; this lane's A-fragment values stay
  // in registers, split at each use
  load_tile<BT>(Vs, qb, a.q_ss, q0, a.seq_q);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float qr[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* p = Vs + (r0 + g) * LD + 8 * kk + t;
    qr[kk][0] = p[0];
    qr[kk][1] = p[8 * LD];
    qr[kk][2] = p[4];
    qr[kk][3] = p[8 * LD + 4];
  }
  __syncthreads();
  load_tile<BS>(Ks, kb, a.k_ss, 0, a.seq_k);
  load_tile<BS>(Vs, vb, a.v_ss, 0, a.seq_k);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = a.scale * kLog2e;
  // rows g (e = 0, 1) and g + 8 (e = 2, 3): running max (log2 units) and
  // this lane's share of the running sum
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<BS>(Ks + (st ^ 1) * STILE, kb, a.k_ss, (it + 1) * BS,
                    a.seq_k);
      load_tile<BS>(Vs + (st ^ 1) * STILE, vb, a.v_ss, (it + 1) * BS,
                    a.seq_k);
    }
    cp_async_commit();
    const float* K = Ks + st * STILE;
    const float* V = Vs + st * STILE;

    float s[NS][4];  // S = Q K^T: columns 8n + 2t (+1)
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA qa;
      split_a(qa, qr[kk]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        FragB f;
        load_bt(f, K, 8 * n, 8 * kk, g, t);
        mma3<false>(s[n], qa, f);
      }
    }

    const int k_left = a.seq_k - it * BS;  // columns at or past it: masked
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            8 * n + 2 * t + (e & 1) < k_left ? s[n][e] * sl2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: a tile has a key
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }

    // O = O corr + P V, the tile's products summed from zero
    float pv[D / 8][4];
    zero(pv);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragA pa;
      acc_to_a(pa, s[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB f;
        load_b(f, V, 8 * j, 8 * n, g, t);
        mma3<false>(pv[n], pa, f);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], corr[e >> 1], pv[n][e]);
    cp_async_wait_all();
    __syncthreads();  // this stage read, the next one landed
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  const long long o_ss = (long long)a.heads * D;
  float* ob = static_cast<float*>(a.o) + (long long)b * a.seq_q * o_ss + h * D;
  const int row0 = q0 + r0 + g;
  store_rows(ob, o_ss, o, row0, a.seq_q, t, inv);
  if (t == 0) {
    float* lse = a.lse + ((long long)b * a.heads + h) * a.seq_q;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < a.seq_q)
        lse[row0 + 8 * r] = (m[r] + log2f(l[r])) * (1.0f / kLog2e);
  }
}

// ------------------------------------------------------- backward: dk/dv

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_bwd_dkv_tf32_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = smem + TILE;
  float* Qs = smem + 2 * TILE;     // [2] Q tiles
  float* Os = Qs + 2 * STILE;      // [2] dO tiles
  float* rows = Os + 2 * STILE;    // [2][lse (log2 units), delta][BS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's keys of the kv tile
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const long long o_ss = (long long)a.heads * D;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + (long long)b * a.seq_q * o_ss + h * D;
  const long long bh = ((long long)b * a.heads + h) * a.seq_q;
  const int nq = (a.seq_q + BS - 1) / BS;

  // q tile `it` into stage `st`: Q, dO, and its rows' lse and delta (zero
  // past Sq)
  auto load_q_tile = [&](int it, int st) {
    load_tile<BS>(Qs + st * STILE, qb, a.q_ss, it * BS, a.seq_q);
    load_tile<BS>(Os + st * STILE, dob, o_ss, it * BS, a.seq_q);
    if (threadIdx.x < BS) {
      const int q = it * BS + threadIdx.x;
      const bool ok = q < a.seq_q;
      rows[st * 2 * BS + threadIdx.x] = ok ? a.lse[bh + q] * kLog2e : 0.f;
      rows[st * 2 * BS + BS + threadIdx.x] = ok ? a.delta[bh + q] : 0.f;
    }
  };
  load_tile<BT>(Ks, kb, a.k_ss, k0, a.seq_k);
  load_tile<BT>(Vs, vb, a.v_ss, k0, a.seq_k);
  load_q_tile(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  for (int it = 0; it < nq; ++it) {
    const int st = it & 1;
    if (it + 1 < nq) load_q_tile(it + 1, st ^ 1);
    cp_async_commit();
    const float* Q = Qs + st * STILE;
    const float* dO = Os + st * STILE;
    const float* rw = rows + st * 2 * BS;

    // S^T = K Q^T and dP^T = V dO^T: rows keys r0 + g (+8), columns q
    // 8n + 2t (+1)
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA kf;
      load_a(kf, Ks, r0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        FragB f;
        load_bt(f, Q, 8 * n, 8 * kk, g, t);
        mma3<true>(s[n], kf, f);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA vf;
      load_a(vf, Vs, r0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        FragB f;
        load_bt(f, dO, 8 * n, 8 * kk, g, t);
        mma3<true>(dp[n], vf, f);
      }
    }
    // P^T and dS^T in place; q columns at or past the end are 0
    const int q_left = a.seq_q - it * BS;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        const float p =
            c < q_left ? exp2f(fmaf(s[n][e], sl2, -rw[c])) : 0.f;
        dp[n][e] = p * (dp[n][e] - rw[BS + c]) * a.scale;
        s[n][e] = p;
      }

    // dV += P^T dO, then dK += dS^T Q, each tile's products summed from
    // zero
    float acc[D / 8][4];
    zero(acc);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragA pa;
      acc_to_a(pa, s[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB f;
        load_b(f, dO, 8 * j, 8 * n, g, t);
        mma3<false>(acc[n], pa, f);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[n][e] += acc[n][e];
        acc[n][e] = 0.f;
      }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragA sa;
      acc_to_a(sa, dp[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB f;
        load_b(f, Q, 8 * j, 8 * n, g, t);
        mma3<false>(acc[n], sa, f);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += acc[n][e];
    cp_async_wait_all();
    __syncthreads();  // this stage read, the next one landed
  }

  const float one[2] = {1.f, 1.f};
  const long long off = (long long)b * a.seq_k * o_ss + h * D;
  store_rows(static_cast<float*>(a.dk) + off, o_ss, dk, k0 + r0 + g, a.seq_k,
             t, one);
  store_rows(static_cast<float*>(a.dv) + off, o_ss, dv, k0 + r0 + g, a.seq_k,
             t, one);
}

// ---------------------------------------------------------- backward: dq

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    flash_bwd_dq_tf32_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = smem + TILE;         // dO
  float* Ks = smem + 2 * TILE;     // [2] K tiles
  float* Vs = Ks + 2 * STILE;      // [2] V tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's rows of the q tile
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const long long o_ss = (long long)a.heads * D;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dob =
      static_cast<const float*>(a.dout) + (long long)b * a.seq_q * o_ss + h * D;
  const int nk = (a.seq_k + BS - 1) / BS;

  load_tile<BT>(Qs, qb, a.q_ss, q0, a.seq_q);
  load_tile<BT>(Os, dob, o_ss, q0, a.seq_q);
  load_tile<BS>(Ks, kb, a.k_ss, 0, a.seq_k);
  load_tile<BS>(Vs, vb, a.v_ss, 0, a.seq_k);
  cp_async_commit();
  // lse (log2 units) and delta of this lane's rows row0, row0 + 8
  const int row0 = q0 + r0 + g;
  const long long bh = ((long long)b * a.heads + h) * a.seq_q;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < a.seq_q;
    lr[r] = ok ? a.lse[bh + row0 + 8 * r] * kLog2e : 0.f;
    dr[r] = ok ? a.delta[bh + row0 + 8 * r] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = a.scale * kLog2e;
  float dq[D / 8][4];
  zero(dq);
  for (int it = 0; it < nk; ++it) {
    const int st = it & 1;
    if (it + 1 < nk) {
      load_tile<BS>(Ks + (st ^ 1) * STILE, kb, a.k_ss, (it + 1) * BS,
                    a.seq_k);
      load_tile<BS>(Vs + (st ^ 1) * STILE, vb, a.v_ss, (it + 1) * BS,
                    a.seq_k);
    }
    cp_async_commit();
    const float* K = Ks + st * STILE;
    const float* V = Vs + st * STILE;

    // S = Q K^T and dP = dO V^T: columns keys 8n + 2t (+1)
    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA qa;
      load_a(qa, Qs, r0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        FragB f;
        load_bt(f, K, 8 * n, 8 * kk, g, t);
        mma3<false>(s[n], qa, f);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      FragA oa;
      load_a(oa, Os, r0, 8 * kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        FragB f;
        load_bt(f, V, 8 * n, 8 * kk, g, t);
        mma3<false>(dp[n], oa, f);
      }
    }
    // dS in place; kv columns at or past the end are 0
    const int k_left = a.seq_k - it * BS;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = 8 * n + 2 * t + (e & 1) < k_left
                            ? exp2f(fmaf(s[n][e], sl2, -lr[e >> 1]))
                            : 0.f;
        dp[n][e] = p * (dp[n][e] - dr[e >> 1]) * a.scale;
      }

    // dQ += dS K, the tile's products summed from zero
    float acc[D / 8][4];
    zero(acc);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragA da;
      acc_to_a(da, dp[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB f;
        load_b(f, K, 8 * j, 8 * n, g, t);
        mma3<false>(acc[n], da, f);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] += acc[n][e];
    cp_async_wait_all();
    __syncthreads();  // this stage read, the next one landed
  }

  const float one[2] = {1.f, 1.f};
  store_rows(static_cast<float*>(a.dq) + (long long)b * a.seq_q * o_ss + h * D,
             o_ss, dq, row0, a.seq_q, t, one);
}

}  // namespace

int flash_fwd_tf32(const FlashArgs& a, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const int dev = sm90::current_device();
  if (dev < 0) return -dev;
  const int e = sm90::allow_smem_once(flash_fwd_tf32_kernel, (int)SMEM_FWD,
                                      dev, smem_set);
  if (e != 0) return e;
  const dim3 grid((a.seq_q + BT - 1) / BT, a.heads, a.batch);
  flash_fwd_tf32_kernel<<<grid, THREADS, SMEM_FWD, stream>>>(a);
  return (int)cudaGetLastError();
}

int flash_bwd_tf32(const BwdArgs& a, cudaStream_t stream) {
  static std::atomic<uint64_t> dkv_set{0}, dq_set{0};
  const int dev = sm90::current_device();
  if (dev < 0) return -dev;
  int e = sm90::allow_smem_once(flash_bwd_dkv_tf32_kernel, (int)SMEM_DKV,
                                dev, dkv_set);
  if (e == 0)
    e = sm90::allow_smem_once(flash_bwd_dq_tf32_kernel, (int)SMEM_DQ, dev,
                              dq_set);
  if (e != 0) return e;
  const dim3 gkv((a.seq_k + BT - 1) / BT, a.heads, a.batch);
  flash_bwd_dkv_tf32_kernel<<<gkv, THREADS, SMEM_DKV, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gq((a.seq_q + BT - 1) / BT, a.heads, a.batch);
  flash_bwd_dq_tf32_kernel<<<gq, THREADS, SMEM_DQ, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vst
