// K4: flash-attention backward for Hopper.
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_dqkv_kernel` (one kv block covers the sequence) and `_dq_kernel` +
// `_dkv_kernel` (the split form), all launched by `_flash_bwd_bhsd`.
//
// From the saved natural-log lse (B, H, Sq) of K1 and delta = rowsum(dO *
// O) (a torch op, as XLA computes it in JAX), per (batch, head):
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
// tensor-core (bf16) or FP32 FMA (fp32) throughput.
//
// Design: the two-kernel form. The TPU's fused `nk == 1` kernel leans on
// one kv block covering the whole sequence in VMEM; here a block holds at
// most 227 KB of shared memory and blocks run in no order, so
//  - the dk/dv kernel owns one kv tile of one (batch, head) and walks
//    every q tile, accumulating dk and dv in f32;
//  - the dq kernel owns one q tile and walks every kv tile, accumulating
//    dq.
// Neither needs atomics, and both are deterministic. Each recomputes S and
// dP, so the pair does 14 rather than 10 * Sq * Sk * D flops. d = 64
// only (every SDXL head), in two instances:
//  - bf16 (every K4 call of the stage-2 path): register-resident
//    mma.sync m16n8k16, as K1's fast kernel (below, `_mma_`);
//  - fp32 (the card-vs-CPU reference step): every tile and product in
//    shared memory, register-blocked FMA loops (exact fp32, no TF32).
// The kv and q tails are zero-filled and masked. WGMMA, TMA and warp
// specialisation are later work.

#include "common.cuh"

namespace vst {
namespace {

constexpr int kThreads = 128;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int batch, seq_q, seq_k, heads;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
};

// the shared-memory kernels (fp32)
template <typename T, int D>
struct BwdCfg {
  static_assert(std::is_same<T, float>::value, "fp32 only");
  static constexpr int BT = 64;  // square tiles
  static constexpr int VEC = Vec<T>::N;
  static constexpr int LDT = D + VEC;   // T per row of the Q/dO/K/V tiles
  static constexpr int LDS = BT + 4;    // floats per row of S, dP
  static constexpr int LDP = BT + VEC;  // T per row of P, dS
  static constexpr int LDA = D + 4;     // floats per row of an accumulator
  static constexpr size_t TILE = sizeof(T) * BT * LDT;
  static constexpr size_t OFF_Q = 0;
  static constexpr size_t OFF_DO = align128(OFF_Q + TILE);
  static constexpr size_t OFF_K = align128(OFF_DO + TILE);
  static constexpr size_t OFF_V = align128(OFF_K + TILE);
  static constexpr size_t OFF_S = align128(OFF_V + TILE);
  static constexpr size_t OFF_DP = align128(OFF_S + sizeof(float) * BT * LDS);
  static constexpr size_t OFF_DS = align128(OFF_DP + sizeof(float) * BT * LDS);
  static constexpr size_t OFF_A1 = align128(OFF_DS + sizeof(T) * BT * LDP);
  static constexpr size_t OFF_ROW = align128(OFF_A1 + sizeof(float) * BT * LDA);
  // the dq kernel stops here; the dk/dv kernel also needs P and a second
  // accumulator
  static constexpr size_t SMEM_DQ = align128(OFF_ROW + sizeof(float) * 2 * BT);
  static constexpr size_t OFF_P = SMEM_DQ;
  static constexpr size_t OFF_A2 = align128(OFF_P + sizeof(T) * BT * LDP);
  static constexpr size_t SMEM_DKV = align128(OFF_A2 + sizeof(float) * BT * LDA);
  static_assert(SMEM_DKV <= 232448, "backward tiles exceed shared memory");
  static_assert(BT % 16 == 0 && D % 16 == 0, "tile shape");
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

// C (M x N, f32, row stride ldc) = [C +] op(A) op(B), op(A) M x K,
// op(B) K x N, all f32 in shared memory; each thread 4 x 4 outputs per
// step.
//   A_T: A is stored (K x M) row-major and op(A) = A^T; else (M x K).
//   B_T: B is stored (N x K) row-major and op(B) = B^T; else (K x N).
template <int M, int N, int K, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void mm(const float* A, int lda, const float* B,
                                   int ldb, float* C, int ldc) {
  constexpr int NQ = N / 4;
  for (int idx = threadIdx.x; idx < (M / 4) * NQ; idx += kThreads) {
    const int r0 = (idx / NQ) * 4, c0 = (idx % NQ) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = ACC ? C[(r0 + i) * ldc + c0 + j] : 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = A_T ? A[k * lda + r0 + i] : A[(r0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = B_T ? B[(c0 + j) * ldb + k] : B[k * ldb + c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(r0 + i) * ldc + c0 + j] = acc[i][j];
  }
}

// lse (in log2 units) and delta of q rows [q0, q0+BT); zero past the end
template <int BT>
__device__ __forceinline__ void load_rows(float* row, const float* lse,
                                          const float* delta, int q0,
                                          int seq_q) {
  for (int r = threadIdx.x; r < BT; r += kThreads) {
    const bool ok = q0 + r < seq_q;
    row[r] = ok ? lse[q0 + r] * kLog2e : 0.f;
    row[BT + r] = ok ? delta[q0 + r] : 0.f;
  }
}

// p and ds of the (q tile q0, kv tile k0) pair from S and dP; masked
// entries are exactly 0
template <typename T, int D, bool WITH_P>
__device__ __forceinline__ void softmax_grad(const float* S, const float* DP,
                                             const float* row, T* P, T* DS,
                                             int q0, int k0, int seq_q,
                                             int seq_k, float sl2,
                                             float scale) {
  using C = BwdCfg<T, D>;
  constexpr int BT = C::BT;
  for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
    const int r = i / BT, c = i - (i / BT) * BT;
    const bool ok = (q0 + r < seq_q) && (k0 + c < seq_k);
    const float p = ok ? exp2f(S[r * C::LDS + c] * sl2 - row[r]) : 0.f;
    const float ds = p * (DP[r * C::LDS + c] - row[BT + r]) * scale;
    if (WITH_P) P[r * C::LDP + c] = from_f<T>(p);
    DS[r * C::LDP + c] = from_f<T>(ds);
  }
}

// rows [r0, r0+BT) of an f32 (BT, LDA) accumulator -> a contiguous
// (B, S, H, D) output at (b, h)
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float* acc, int b,
                                           int h, int r0, int seq,
                                           int heads) {
  using C = BwdCfg<T, D>;
  constexpr int VEC = C::VEC, VPR = D / VEC;
  for (int i = threadIdx.x; i < C::BT * VPR; i += kThreads) {
    const int r = i / VPR, cv = i - (i / VPR) * VPR;
    if (r0 + r >= seq) continue;
    float vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) vals[e] = acc[r * C::LDA + cv * VEC + e];
    pack16<T>(out + (((long long)b * seq + r0 + r) * heads + h) * D + cv * VEC,
              vals);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs a) {
  using C = BwdCfg<T, D>;
  constexpr int BT = C::BT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + C::OFF_Q);
  T* DOs = reinterpret_cast<T*>(smem + C::OFF_DO);
  T* Ks = reinterpret_cast<T*>(smem + C::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + C::OFF_V);
  float* S = reinterpret_cast<float*>(smem + C::OFF_S);
  float* DP = reinterpret_cast<float*>(smem + C::OFF_DP);
  T* DSs = reinterpret_cast<T*>(smem + C::OFF_DS);
  float* dK = reinterpret_cast<float*>(smem + C::OFF_A1);
  float* row = reinterpret_cast<float*>(smem + C::OFF_ROW);
  T* Ps = reinterpret_cast<T*>(smem + C::OFF_P);
  float* dV = reinterpret_cast<float*>(smem + C::OFF_A2);

  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long o_ss = (long long)a.heads * D;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + (long long)b * a.seq_q * o_ss + h * D;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.seq_q;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.seq_q;

  load_tile<T, D, BT, C::LDT>(Ks, kb, a.k_ss, k0, a.seq_k);
  load_tile<T, D, BT, C::LDT>(Vs, vb, a.v_ss, k0, a.seq_k);
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    dK[(i / D) * C::LDA + i % D] = 0.f;
    dV[(i / D) * C::LDA + i % D] = 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  const int nq = (a.seq_q + BT - 1) / BT;
  for (int t = 0; t < nq; ++t) {
    const int q0 = t * BT;
    __syncthreads();  // the previous tile's products are done
    load_tile<T, D, BT, C::LDT>(Qs, qb, a.q_ss, q0, a.seq_q);
    load_tile<T, D, BT, C::LDT>(DOs, dob, o_ss, q0, a.seq_q);
    load_rows<BT>(row, lse, delta, q0, a.seq_q);
    __syncthreads();
    mm<BT, BT, D, false, true, false>(Qs, C::LDT, Ks, C::LDT, S, C::LDS);
    mm<BT, BT, D, false, true, false>(DOs, C::LDT, Vs, C::LDT, DP, C::LDS);
    __syncthreads();
    softmax_grad<T, D, true>(S, DP, row, Ps, DSs, q0, k0, a.seq_q, a.seq_k,
                             sl2, a.scale);
    __syncthreads();
    mm<BT, D, BT, true, false, true>(Ps, C::LDP, DOs, C::LDT, dV, C::LDA);
    mm<BT, D, BT, true, false, true>(DSs, C::LDP, Qs, C::LDT, dK, C::LDA);
  }
  __syncthreads();
  store_rows<T, D>(static_cast<T*>(a.dk), dK, b, h, k0, a.seq_k, a.heads);
  store_rows<T, D>(static_cast<T*>(a.dv), dV, b, h, k0, a.seq_k, a.heads);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a) {
  using C = BwdCfg<T, D>;
  constexpr int BT = C::BT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + C::OFF_Q);
  T* DOs = reinterpret_cast<T*>(smem + C::OFF_DO);
  T* Ks = reinterpret_cast<T*>(smem + C::OFF_K);
  T* Vs = reinterpret_cast<T*>(smem + C::OFF_V);
  float* S = reinterpret_cast<float*>(smem + C::OFF_S);
  float* DP = reinterpret_cast<float*>(smem + C::OFF_DP);
  T* DSs = reinterpret_cast<T*>(smem + C::OFF_DS);
  float* dQ = reinterpret_cast<float*>(smem + C::OFF_A1);
  float* row = reinterpret_cast<float*>(smem + C::OFF_ROW);

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long o_ss = (long long)a.heads * D;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dob = static_cast<const T*>(a.dout) + (long long)b * a.seq_q * o_ss + h * D;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.seq_q;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.seq_q;

  load_tile<T, D, BT, C::LDT>(Qs, qb, a.q_ss, q0, a.seq_q);
  load_tile<T, D, BT, C::LDT>(DOs, dob, o_ss, q0, a.seq_q);
  load_rows<BT>(row, lse, delta, q0, a.seq_q);
  for (int i = threadIdx.x; i < BT * D; i += kThreads)
    dQ[(i / D) * C::LDA + i % D] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int nk = (a.seq_k + BT - 1) / BT;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // the previous tile's products are done
    load_tile<T, D, BT, C::LDT>(Ks, kb, a.k_ss, k0, a.seq_k);
    load_tile<T, D, BT, C::LDT>(Vs, vb, a.v_ss, k0, a.seq_k);
    __syncthreads();
    mm<BT, BT, D, false, true, false>(Qs, C::LDT, Ks, C::LDT, S, C::LDS);
    mm<BT, BT, D, false, true, false>(DOs, C::LDT, Vs, C::LDT, DP, C::LDS);
    __syncthreads();
    softmax_grad<T, D, false>(S, DP, row, nullptr, DSs, q0, k0, a.seq_q,
                              a.seq_k, sl2, a.scale);
    __syncthreads();
    mm<BT, D, BT, false, false, true>(DSs, C::LDP, Ks, C::LDT, dQ, C::LDA);
  }
  __syncthreads();
  store_rows<T, D>(static_cast<T*>(a.dq), dQ, b, h, q0, a.seq_q, a.heads);
}

// ------------------------------------------- bf16, d = 64: registers
//
// The stage-2 path's every K4 call is bf16 at d = 64. Here each warp
// keeps its 16 rows' operands as mma.sync m16n8k16 A fragments and its
// products in f32 registers, as K1's register-resident kernel does:
//  - dk/dv kernel: a warp owns 16 kv rows (K and V as A fragments) and,
//    per 64-row q tile (double-buffered through cp.async), forms
//    S^T = K Q^T and dP^T = V dO^T, turns them into P^T and dS^T in
//    registers (the accumulator layout of one product is the A-operand
//    layout of the next), then dV += P^T dO and dK += dS^T Q with dO and
//    Q read transposed by ldmatrix;
//  - dq kernel: a warp owns 16 q rows (Q and dO as A fragments) and, per
//    64-row kv tile, forms S = Q K^T and dP = dO V^T, then dQ += dS K.

constexpr int kMmaBT = 64;        // rows per block and per streamed tile
constexpr int kMmaLD = 64 + 8;    // bf16 per shared row (16 B pad)
constexpr size_t kMmaTile = sizeof(bf16) * kMmaBT * kMmaLD;
// two resident tiles, two stages of two streamed tiles, two stages of the
// lse/delta rows (dk/dv kernel)
constexpr size_t kMmaSmem = 6 * kMmaTile + sizeof(float) * 4 * kMmaBT;

template <int ROWS>
__device__ __forceinline__ void load_tile_async64(bf16* dst, const bf16* src,
                                                  long long row_stride,
                                                  int r0, int nrows) {
  constexpr int VPR = 64 / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, cv = i - r * VPR;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * kMmaLD + cv * 8,
               ok ? src + (long long)(r0 + r) * row_stride + cv * 8 : src,
               ok);
  }
}

// A fragments of a warp's 16 rows of a (rows, 64) shared tile
__device__ __forceinline__ void load_a_frags(uint32_t (*f)[4],
                                             const bf16* tile, int warp,
                                             int g, int tig) {
  const bf16* r0 = tile + (warp * 16 + g) * kMmaLD + tig * 2;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = ld_u32(r0 + kk * 16);
    f[kk][1] = ld_u32(r0 + 8 * kMmaLD + kk * 16);
    f[kk][2] = ld_u32(r0 + kk * 16 + 8);
    f[kk][3] = ld_u32(r0 + 8 * kMmaLD + kk * 16 + 8);
  }
}

// acc[nb] (16 x 8 blocks, nb < 8) = A (16 x 64 fragments) . B^T, B's 64
// rows read straight from a (64, 64) row-major shared tile
__device__ __forceinline__ void mma_abT(float (*acc)[4], uint32_t (*af)[4],
                                        const bf16* tile, int g, int tig) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
    const bf16* br = tile + (nb * 8 + g) * kMmaLD + tig * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t bb[2] = {ld_u32(br + kk * 16), ld_u32(br + kk * 16 + 8)};
      mma_16816(acc[nb], af[kk], bb);
    }
  }
}

// acc (16 x 64) += A (16 x 64 fragments over the tile's rows) . tile, the
// (64, 64) row-major tile read transposed by ldmatrix
__device__ __forceinline__ void mma_ab(float (*acc)[4], uint32_t (*af)[4],
                                       const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* tr = tile + (kk * 16 + (lane & 15)) * kMmaLD;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      uint32_t bb[2];
      ldmatrix_x2_trans(bb, tr + nd * 8);
      mma_16816(acc[nd], af[kk], bb);
    }
  }
}

// an accumulator block pair nb = 2j, 2j+1 becomes A fragment j
__device__ __forceinline__ void to_a_frag(uint32_t (*f)[4], int nb,
                                          const float* c) {
  f[nb >> 1][(nb & 1) * 2] = pack_bf16x2(c[0], c[1]);
  f[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16x2(c[2], c[3]);
}

// rows r and r + 8 of a warp's (16, 64) f32 accumulator -> bf16 output
__device__ __forceinline__ void store_acc(bf16* out, float (*acc)[4],
                                          int b, int h, int row0, int seq,
                                          int heads, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= seq) continue;
    bf16* o = out + (((long long)b * seq + row) * heads + h) * 64 + tig * 2;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
      *reinterpret_cast<uint32_t*>(o + nd * 8) =
          pack_bf16x2(acc[nd][r * 2], acc[nd][r * 2 + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma_kernel(const BwdArgs a) {
  constexpr int BT = kMmaBT, LD = kMmaLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BT * LD;
  bf16* QD = Vs + BT * LD;  // [stage][Q, dO][BT][LD]
  float* rows = reinterpret_cast<float*>(QD + 4 * BT * LD);  // [stage][2][BT]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long o_ss = (long long)a.heads * 64;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + (long long)b * a.seq_q * o_ss + h * 64;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.seq_q;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.seq_q;
  const int nq = (a.seq_q + BT - 1) / BT;

  auto load_q_tile = [&](int stage, int q0) {
    bf16* qd = QD + stage * 2 * BT * LD;
    load_tile_async64<BT>(qd, qb, a.q_ss, q0, a.seq_q);
    load_tile_async64<BT>(qd + BT * LD, dob, o_ss, q0, a.seq_q);
    float* rw = rows + stage * 2 * BT;
    for (int r = threadIdx.x; r < BT; r += kThreads) {
      const bool ok = q0 + r < a.seq_q;
      rw[r] = ok ? lse[q0 + r] * kLog2e : 0.f;
      rw[BT + r] = ok ? delta[q0 + r] : 0.f;
    }
  };
  load_tile_async64<BT>(Ks, kb, a.k_ss, k0, a.seq_k);
  load_tile_async64<BT>(Vs, vb, a.v_ss, k0, a.seq_k);
  load_q_tile(0, 0);
  cp_async_commit();

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int t = 0; t < nq; ++t) {
    const int st = t & 1;
    if (t + 1 < nq) load_q_tile(st ^ 1, (t + 1) * BT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a_frags(kf, Ks, warp, g, tig);
      load_a_frags(vf, Vs, warp, g, tig);
    }
    const bf16* Qt = QD + st * 2 * BT * LD;
    const bf16* Dt = Qt + BT * LD;
    const float* lr = rows + st * 2 * BT;
    const float* dr = lr + BT;

    float s[8][4], dp[8][4];
    mma_abT(s, kf, Qt, g, tig);   // S^T = K Q^T   (kv rows x q cols)
    mma_abT(dp, vf, Dt, g, tig);  // dP^T = V dO^T
    uint32_t pf[4][4], sf[4][4];
    const int q0 = t * BT;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + tig * 2 + (e & 1);
        const bool ok = q0 + col < a.seq_q;
        const float p = ok ? exp2f(s[nb][e] * sl2 - lr[col]) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - dr[col]) * a.scale;
      }
      to_a_frag(pf, nb, s[nb]);
      to_a_frag(sf, nb, dp[nb]);
    }
    mma_ab(dv, pf, Dt, lane);  // dV += P^T dO
    mma_ab(dk, sf, Qt, lane);  // dK += dS^T Q
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  const int row0 = k0 + warp * 16 + g;
  store_acc(static_cast<bf16*>(a.dk), dk, b, h, row0, a.seq_k, a.heads, tig);
  store_acc(static_cast<bf16*>(a.dv), dv, b, h, row0, a.seq_k, a.heads, tig);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_mma_kernel(const BwdArgs a) {
  constexpr int BT = kMmaBT, LD = kMmaLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* DOs = Qs + BT * LD;
  bf16* KV = DOs + BT * LD;  // [stage][K, V][BT][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long o_ss = (long long)a.heads * 64;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + (long long)b * a.seq_q * o_ss + h * 64;
  const float* lse = a.lse + ((long long)b * a.heads + h) * a.seq_q;
  const float* delta = a.delta + ((long long)b * a.heads + h) * a.seq_q;
  const int nk = (a.seq_k + BT - 1) / BT;

  load_tile_async64<BT>(Qs, qb, a.q_ss, q0, a.seq_q);
  load_tile_async64<BT>(DOs, dob, o_ss, q0, a.seq_q);
  load_tile_async64<BT>(KV, kb, a.k_ss, 0, a.seq_k);
  load_tile_async64<BT>(KV + BT * LD, vb, a.v_ss, 0, a.seq_k);
  cp_async_commit();

  // lse (log2 units) and delta of this thread's rows g and g + 8
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    const bool ok = row < a.seq_q;
    lr[r] = ok ? lse[row] * kLog2e : 0.f;
    dr[r] = ok ? delta[row] : 0.f;
  }
  uint32_t qf[4][4], df[4][4];
  float dq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int t = 0; t < nk; ++t) {
    const int st = t & 1;
    if (t + 1 < nk) {
      bf16* nkv = KV + (st ^ 1) * 2 * BT * LD;
      load_tile_async64<BT>(nkv, kb, a.k_ss, (t + 1) * BT, a.seq_k);
      load_tile_async64<BT>(nkv + BT * LD, vb, a.v_ss, (t + 1) * BT,
                            a.seq_k);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      load_a_frags(qf, Qs, warp, g, tig);
      load_a_frags(df, DOs, warp, g, tig);
    }
    const bf16* Kt = KV + st * 2 * BT * LD;
    const bf16* Vt = Kt + BT * LD;

    float s[8][4], dp[8][4];
    mma_abT(s, qf, Kt, g, tig);   // S = Q K^T
    mma_abT(dp, df, Vt, g, tig);  // dP = dO V^T
    uint32_t sf[4][4];
    const int k0 = t * BT;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + tig * 2 + (e & 1);
        const int r = e >> 1;
        const float p =
            col < a.seq_k ? exp2f(s[nb][e] * sl2 - lr[r]) : 0.f;
        dp[nb][e] = p * (dp[nb][e] - dr[r]) * a.scale;
      }
      to_a_frag(sf, nb, dp[nb]);
    }
    mma_ab(dq, sf, Kt, lane);  // dQ += dS K
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  store_acc(static_cast<bf16*>(a.dq), dq, b, h, q0 + warp * 16 + g, a.seq_q,
            a.heads, tig);
}

int launch_mma64(const BwdArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMmaSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMmaSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 gkv((a.seq_k + kMmaBT - 1) / kMmaBT, a.heads, a.batch);
  flash_bwd_dkv_mma_kernel<<<gkv, kThreads, kMmaSmem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((a.seq_q + kMmaBT - 1) / kMmaBT, a.heads, a.batch);
  flash_bwd_dq_mma_kernel<<<gq, kThreads, kMmaSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const BwdArgs& a, cudaStream_t stream) {
  using C = BwdCfg<T, D>;
  auto kdkv = flash_bwd_dkv_kernel<T, D>;
  auto kdq = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_DKV);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::SMEM_DQ);
  if (e != cudaSuccess) return (int)e;
  dim3 gkv((a.seq_k + C::BT - 1) / C::BT, a.heads, a.batch);
  kdkv<<<gkv, kThreads, C::SMEM_DKV, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((a.seq_q + C::BT - 1) / C::BT, a.heads, a.batch);
  kdq<<<gq, kThreads, C::SMEM_DQ, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (head_dim != 64) return -2;
  if (dtype == vst::kFloat32) return vst::launch<float, 64>(a, s);
  if (dtype == vst::kBFloat16) return vst::launch_mma64(a, s);
  return -1;
}
