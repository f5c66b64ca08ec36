// K4 in bf16 at head dims 128-512: the flash-attention backward on wgmma
// + TMA, each block owning a slice of D columns of its output ("wgmma_sliced"
// route of ops/flash_attention.py's `bwd_route`).
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
// Why d = 64's design does not carry over: its dk/dv kernel keeps dK and
// dV of 64 kv rows in the registers of a warpgroup (32 floats a thread
// each at d = 64) and K, V and three stages of whole Q and dO tiles in
// shared memory. At d = 512, dK and dV alone would take 256 floats a
// thread each, and one 64-row Q tile plus one dO tile 128 KB.
//
// Design: the two-kernel form (no atomics, deterministic), each block
// owning 64 rows (one consumer warpgroup) and one slice of at most 128 of
// the D output columns (`bwd_plan` in ops/flash_attention.py; the last
// slice is 64 wide where D / 64 is odd). Grid: (row tiles, heads x
// slices, batch).
//  - The block's own rows (K and V for dk/dv, Q and dO for dq) arrive once
//    by TMA, the whole D as 64-wide 128-byte-swizzled panels: 2 x 64 KB at
//    d = 512.
//  - The other side streams one 64-wide panel at a time (Q and dO panel p
//    for dk/dv, 32 rows; K and V panel p for dq, 64 rows) through a ring
//    of stages filled by one producer thread. S (S^T for dk/dv) and dP
//    take the full D by wgmma over every panel in turn, so the registers
//    hold S and dP of one tile, not of one panel per stage. The slice's
//    own panels come last in each tile's walk and stay in the ring until
//    the slice's products have read them: dV += P^T dO, dK += dS^T Q (or
//    dQ += dS K) as register-A wgmmas over the stored panels, MN-major
//    through the transpose bit.
//  - Registers: dK and dV of the slice (64 floats a thread each), S^T and
//    dP^T over 32 q columns (16 each) for dk/dv; dQ (64) and S, dP over 64
//    keys (32 each) for dq. 256 threads, one block an SM.
// Each slice recomputes S and dP over the full D: the dk/dv kernel does
// (4 * slices + 4) and the dq kernel (4 * slices + 2) * Sq * Sk * D flops
// a (batch, head), 38 at d = 512 (4 slices) against the 10 of JAX's cost
// estimate, 14 at d = 128. Bound on the H100: tensor-core throughput at
// these flops (the bytes are ~8 * S * D elements).
//
// Every TMA box starts inside its sequence, so rows past the end arrive
// as zeros; streamed columns past the end get p = ds = 0 before any
// product, and output rows past the end are not written.

#include "common.cuh"
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace vst {
namespace {

using namespace sm90;

constexpr int SL_ROWS = 64;        // a block's own rows: one warpgroup
constexpr int SL_MAXP = 2;         // 64-wide panels of a block's slice
constexpr int SL_MAX_STAGES = 8;   // ring stages at most
constexpr uint32_t SL_OWN_PANEL = SL_ROWS * 128;
constexpr long long SL_SMEM_MAX = 232448;
// 1024 bytes of alignment slack, then 1024 of barriers before the tiles
constexpr long long SL_SMEM_HEAD = 2048;

// streamed rows a tile: q rows (dk/dv kernel), keys (dq kernel)
template <bool DQ>
__host__ __device__ constexpr int sl_stream() {
  return DQ ? 64 : 32;
}

// the ring stages (a 64-wide panel of each of the two streamed tensors)
// that fit beside the own rows' np panels; `bwd_plan` computes the same
constexpr int sl_stages(int np, int bn) {
  const long long room = SL_SMEM_MAX - SL_SMEM_HEAD - 2LL * np * SL_OWN_PANEL;
  const long long fit = room / (2LL * bn * 128);
  return fit < SL_MAX_STAGES ? (int)fit : SL_MAX_STAGES;
}

// the widest head (8 panels) still leaves a stage in flight beside the
// slice's held panels in both kernels (6 for dq, 8 for dk/dv)
static_assert(sl_stages(8, sl_stream<true>()) >= SL_MAXP + 1,
              "dq ring too shallow at d = 512");
static_assert(sl_stages(8, sl_stream<false>()) >= SL_MAXP + 1,
              "dk/dv ring too shallow at d = 512");
static_assert(sl_stages(8, sl_stream<true>()) == 6 &&
                  sl_stages(8, sl_stream<false>()) == 8 &&
                  sl_stages(2, sl_stream<true>()) == 8,
              "bwd_plan's stage counts");
static_assert(SL_SMEM_HEAD - 1024 >= 8 * (1 + 2 * SL_MAX_STAGES),
              "barriers fit their kilobyte");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the slice's m panels of a warpgroup's (64, 64 m) f32 accumulator, rows
// row0 and row0 + 8 -> a contiguous (B, S, H, D) bf16 output at (b, h),
// columns c0 ..
__device__ __forceinline__ void store_slice(bf16* out, const float* acc,
                                            int b, int h, int row0, int seq,
                                            int heads, int d, int c0, int m,
                                            int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq) continue;
    bf16* o = out + (((long long)b * seq + row) * heads + h) * d + c0 + 2 * t4;
#pragma unroll
    for (int jp = 0; jp < SL_MAXP; ++jp) {
      if (jp >= m) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(o + 64 * jp + 8 * i) =
            pack_bf16x2(acc[32 * jp + 4 * i + 2 * r],
                        acc[32 * jp + 4 * i + 2 * r + 1]);
    }
  }
}

// DQ = false: the dk/dv kernel (own K, V; streams Q, dO; S^T = K Q^T,
// dP^T = V dO^T). DQ = true: the dq kernel (own Q, dO; streams K, V;
// S = Q K^T, dP = dO V^T). NP = D / 64 panels, nsl slices, nst stages.
// NP is a template argument so that the panel walk unrolls: with a
// runtime walk, ptxas serialises every wgmma of the kernel (its
// accumulators are carried across the loop's back edge while a group is
// in flight).
template <bool DQ, int NP>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_sliced_sm90_kernel(const __grid_constant__ CUtensorMap t_own0,
                                 const __grid_constant__ CUtensorMap t_own1,
                                 const __grid_constant__ CUtensorMap t_str0,
                                 const __grid_constant__ CUtensorMap t_str1,
                                 const BwdArgs a, int nsl, int nst) {
  constexpr int np = NP;
  constexpr int BN = sl_stream<DQ>();
  constexpr uint32_t STR_PANEL = BN * 128;
  constexpr uint32_t STAGE = 2 * STR_PANEL;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* bar_own = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = bar_own + 1;
  uint64_t* empty = full + SL_MAX_STAGES;
  unsigned char* own0 = smem + 1024;
  unsigned char* own1 = own0 + np * SL_OWN_PANEL;
  unsigned char* ring = own1 + np * SL_OWN_PANEL;

  const int wg = threadIdx.x / 128;
  const int r0 = blockIdx.x * SL_ROWS;
  const int sl = blockIdx.y % nsl, h = blockIdx.y / nsl, b = blockIdx.z;
  const int p0 = SL_MAXP * sl;            // the slice's first panel
  const int m = min(SL_MAXP, np - p0);    // and its panel count
  const int seq_own = DQ ? a.seq_q : a.seq_k;
  const int seq_str = DQ ? a.seq_k : a.seq_q;
  const int nt = (seq_str + BN - 1) / BN;
  // the panel a streamed tile's i-th stage holds: the panels outside the
  // slice in order, then the slice's own
  auto panel = [&](int i) {
    return i < np - m ? (i < p0 ? i : i + m) : p0 + i - (np - m);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_own, 2 * np * SL_OWN_PANEL);
      for (int p = 0; p < np; ++p) {
        tma_load_4d(own0 + p * SL_OWN_PANEL, &t_own0, bar_own, p * 64, h, r0,
                    b);
        tma_load_4d(own1 + p * SL_OWN_PANEL, &t_own1, bar_own, p * 64, h, r0,
                    b);
      }
      int it = 0;
      for (int t = 0; t < nt; ++t)
        for (int i = 0; i < np; ++i, ++it) {
          const int st = it % nst, p = panel(i);
          mbar_wait(&empty[st], ((it / nst) & 1) ^ 1);
          mbar_arrive_tx(&full[st], STAGE);
          unsigned char* s0 = ring + st * STAGE;
          tma_load_4d(s0, &t_str0, &full[st], p * 64, h, t * BN, b);
          tma_load_4d(s0 + STR_PANEL, &t_str1, &full[st], p * 64, h, t * BN,
                      b);
        }
    }
    return;
  }
  // -------------------------------------------------------- consumers
  const int tid = threadIdx.x - 128;
  const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
  const uint32_t o0 = smem_u32(own0), o1 = smem_u32(own1);
  const uint32_t rg = smem_u32(ring);
  const float sl2 = a.scale * kLog2e;
  const long long bh = ((long long)b * a.heads + h) * a.seq_q;
  const int row0 = r0 + warp * 16 + lane / 4;  // this thread's own rows

  // dK (dk/dv) or dQ (dq), and dV (dk/dv); 32 floats a panel
  float acc0[SL_MAXP * 32], acc1[DQ ? 1 : SL_MAXP * 32];
  float s[BN / 2], dp[BN / 2];
  uint32_t pf[BN / 16][4], sf[BN / 16][4];
#pragma unroll
  for (int i = 0; i < SL_MAXP * 32; ++i) acc0[i] = 0.f;
  if constexpr (!DQ) {
#pragma unroll
    for (int i = 0; i < SL_MAXP * 32; ++i) acc1[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
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

  mbar_wait(bar_own, 0);
  int it = 0;
  for (int t = 0; t < nt; ++t) {
    // dk/dv: lse (log2 units) and delta of this thread's q columns
    // 8i + 2 t4 + {0, 1}, zero past Sq
    float2 lc[BN / 8], dc[BN / 8];
    if constexpr (!DQ) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int q = t * BN + 8 * i + 2 * t4;
        const bool ok0 = q < a.seq_q, ok1 = q + 1 < a.seq_q;
        lc[i] = make_float2(ok0 ? a.lse[bh + q] * kLog2e : 0.f,
                            ok1 ? a.lse[bh + q + 1] * kLog2e : 0.f);
        dc[i] = make_float2(ok0 ? a.delta[bh + q] : 0.f,
                            ok1 ? a.delta[bh + q + 1] : 0.f);
      }
    }
    // S (S^T) and dP (dP^T) over every panel of D; a stage outside the
    // slice goes back once the products that read it are done
#pragma unroll
    for (int i = 0; i < np; ++i, ++it) {
      const int st = it % nst;
      const uint32_t s0 = rg + st * STAGE;
      const uint32_t off = panel(i) * SL_OWN_PANEL;
      mbar_wait(&full[st], (it / nst) & 1);
      fence_regs<BN / 2>(s);
      fence_regs<BN / 2>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN>(s, desc_kmajor(o0 + off, SL_OWN_PANEL, kk),
                     desc_kmajor(s0, STR_PANEL, kk), i > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN>(dp, desc_kmajor(o1 + off, SL_OWN_PANEL, kk),
                     desc_kmajor(s0 + STR_PANEL, STR_PANEL, kk),
                     i > 0 || kk > 0);
      wgmma_commit();
      if (i > 0 && i - 1 < np - m) {
        wgmma_wait<1>();
        fence_regs<BN / 2>(s);
        fence_regs<BN / 2>(dp);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % nst]);
      }
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(s);
    fence_regs<BN / 2>(dp);
    // P and dS in place (streamed columns at or past the end: 0), then
    // rounded to bf16 as A fragments
    const int left = seq_str - t * BN;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float l, dl;
        if constexpr (DQ) {
          l = lr[e >> 1];
          dl = dr[e >> 1];
        } else {
          l = (e & 1) ? lc[i].y : lc[i].x;
          dl = (e & 1) ? dc[i].y : dc[i].x;
        }
        const bool ok = 8 * i + 2 * t4 + (e & 1) < left;
        const float p = ex2(fmaf(s[4 * i + e], sl2, -l));
        dp[4 * i + e] = ok ? p * (dp[4 * i + e] - dl) * a.scale : 0.f;
        s[4 * i + e] = ok ? p : 0.f;
      }
    if constexpr (!DQ) pack_a<BN>(pf, s);
    pack_a<BN>(sf, dp);
    // the slice's products over the tile's last m stages, which hold the
    // slice's panels of the streamed tensors; then those stages go back
    fence_regs<SL_MAXP * 32>(acc0);
    if constexpr (!DQ) {
      fence_regs<SL_MAXP * 32>(acc1);
      fence_p<BN / 16>(pf);
    }
    fence_p<BN / 16>(sf);
    wgmma_fence();
#pragma unroll
    for (int jp = 0; jp < SL_MAXP; ++jp) {
      if (jp >= m) continue;
      const uint32_t s0 = rg + ((it - m + jp) % nst) * STAGE;
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        if constexpr (DQ) {
          // dQ += dS K
          wgmma_rs_vt<64>(acc0 + 32 * jp, sf[j],
                          desc_mnmajor(s0, STR_PANEL, j), 1);
        } else {
          // dV += P^T dO, dK += dS^T Q
          wgmma_rs_vt<64>(acc1 + 32 * jp, pf[j],
                          desc_mnmajor(s0 + STR_PANEL, STR_PANEL, j), 1);
          wgmma_rs_vt<64>(acc0 + 32 * jp, sf[j],
                          desc_mnmajor(s0, STR_PANEL, j), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<SL_MAXP * 32>(acc0);
    if constexpr (!DQ) fence_regs<SL_MAXP * 32>(acc1);
    __syncwarp();
    if (lane == 0)
      for (int jp = 0; jp < m; ++jp) mbar_arrive(&empty[(it - m + jp) % nst]);
  }
  if constexpr (DQ) {
    store_slice(static_cast<bf16*>(a.dq), acc0, b, h, row0, seq_own, a.heads,
                64 * np, 64 * p0, m, t4);
  } else {
    store_slice(static_cast<bf16*>(a.dk), acc0, b, h, row0, seq_own, a.heads,
                64 * np, 64 * p0, m, t4);
    store_slice(static_cast<bf16*>(a.dv), acc1, b, h, row0, seq_own, a.heads,
                64 * np, 64 * p0, m, t4);
  }
}

template <bool DQ, int NP>
int launch_sliced(const BwdArgs& a, int dev, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr int BN = sl_stream<DQ>();
  constexpr int np = NP, d = 64 * NP;
  constexpr int nsl = (np + SL_MAXP - 1) / SL_MAXP;
  constexpr int nst = sl_stages(np, BN);
  static_assert(nst >= SL_MAXP + 1, "a stage in flight beside the slice");
  const long long smem =
      SL_SMEM_HEAD + 2LL * np * SL_OWN_PANEL + (long long)nst * 2 * BN * 128;
  if (smem > SL_SMEM_MAX) return -2;
  auto kernel = flash_bwd_sliced_sm90_kernel<DQ, NP>;
  int e = allow_smem_once(kernel, (int)SL_SMEM_MAX, dev, smem_set);
  if (e != 0) return e;
  // 4-D (D, H, S, B) maps of the strided views, boxes of one 64-wide
  // panel by the own (64) or streamed (BN) rows
  auto map = [&](CUtensorMap* t, const void* p, int seq, long long sb,
                 long long ss, long long sh, int rows) {
    return cached_bshd_tensor_map(t, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p,
                                  a.batch, seq, a.heads, d, sb, ss, sh, 64,
                                  rows, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  const long long do_ss = (long long)a.heads * d;
  const long long do_sb = (long long)a.seq_q * do_ss;
  const int q_rows = DQ ? SL_ROWS : BN, kv_rows = DQ ? BN : SL_ROWS;
  CUtensorMap tq, tdo, tk, tv;
  e = map(&tq, a.q, a.seq_q, a.q_sb, a.q_ss, a.q_sh, q_rows);
  if (e == 0) e = map(&tdo, a.dout, a.seq_q, do_sb, do_ss, d, q_rows);
  if (e == 0) e = map(&tk, a.k, a.seq_k, a.k_sb, a.k_ss, a.k_sh, kv_rows);
  if (e == 0) e = map(&tv, a.v, a.seq_k, a.v_sb, a.v_ss, a.v_sh, kv_rows);
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  const int seq_own = DQ ? a.seq_q : a.seq_k;
  const dim3 grid((seq_own + SL_ROWS - 1) / SL_ROWS, a.heads * nsl, a.batch);
  if constexpr (DQ)
    kernel<<<grid, 256, (size_t)smem, stream>>>(tq, tdo, tk, tv, a, nsl,
                                                 nst);
  else
    kernel<<<grid, 256, (size_t)smem, stream>>>(tk, tv, tq, tdo, a, nsl,
                                                 nst);
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
  if ((long long)a.heads * ((head_dim / 64 + SL_MAXP - 1) / SL_MAXP) > 65535)
    return -2;
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
