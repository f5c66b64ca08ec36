// K1 (bf16, head_dim 320 / 384 / 448 / 512): flash-attention forward on
// Hopper's warpgroup products and tensor memory accelerator, for the VAE's
// mid-block attention under --vae_dtype bfloat16 (one head, d = 512,
// 16384 tokens at 1024^2, 4096 at 512^2).
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_attn_kernel_packed` (launched by `_flash_fwd_bs_hd`: d = 384 and 512
// at one head, which `_packable` packs) and `_attn_kernel` (launched by
// `_flash_fwd_bhsd`: d = 320 and 448) for bf16 inputs. bf16 d <= 256 runs
// on flash_attention_sm90.cu, fp32 d = 512 on flash_attention_f32.cu and
// the other fp32 head dims on flash_attention.cu.
//
// Same function: per (batch, head), out = softmax(q k^T * scale) v with
// f32 logits, running max and sum, P rounded to bf16 for the P.V product
// and O once at the output; lse (B, H, Sq) f32 in natural-log units. q, k
// and v are read as (B, S, H, D) strided views (the fused (B, S, 3*H*D)
// projection in place); out is (B, Sq, H*D).
//
// Bound on the H100: 4 * Sq * Sk * D flops against 4 * S * D * 2 bytes a
// head, so at S >= 4096 tensor-core throughput bounds it (0.556 ms at
// (1,16384,1x512)). Three things stand in the way at these head dims:
//
// - O does not fit one warpgroup: 64 rows x 512 columns in f32 is 256
//   registers a thread, over the limit of 255. So two consumer warpgroups
//   own the same 64 query rows and split O by columns at a multiple of 64
//   (one 128-byte-swizzled V panel): D0 = 64 * ceil(D / 128) columns for
//   the first, the rest for the second (320: 192 + 128, 384: 192 + 192,
//   448: 256 + 192, 512: 256 + 256), so that each holds at most 128 O
//   floats a thread (ops/flash_attention.py: `wide_o_split`).
// - S must not be computed twice (Q K^T is half the flops). The two
//   warpgroups split its contraction instead: each computes the partial
//   S (64 x 64 keys) over its half of D's K steps (m64n64k16, Q and K both
//   K-major in shared memory), writes it to shared memory, and adds the
//   other's after a named barrier. Addition commutes, so both hold the
//   same full S bit for bit, run the same online softmax on it (cheap at
//   these head dims: 64 exp2 per 64 * D * 2 multiply-adds a row), and
//   keep P in registers as the A operand of O[:, part] += P V[:, part]
//   (m64n{D0 or D - D0}k16, V MN-major through the transpose bit). Q is
//   read from shared memory once a tile, not once for each warpgroup, and
//   P never goes through shared memory. (The alternative, splitting S by
//   key columns, exchanging row maxima and staging P in shared memory,
//   reads Q twice a tile and needs a proxy fence before the P.V product.)
// - The exchange and the softmax would leave the tensor cores idle. So
//   once S_t has landed, each warpgroup issues O += P_{t-1} V_{t-1} and
//   exchanges S_t and runs its softmax while that product is in flight;
//   O is rescaled once it has landed, and only where a row's max rose.
//   The first tile is peeled off the loop, so that no branch surrounds a
//   product in flight (ptxas serialises the products otherwise).
//
// Shared memory holds Q (64 rows x D), one K and one V tile of 64 keys
// (64 KB each at D = 512) and the two 16 KB partial-S tiles: 224 KB at D =
// 512, so there is one buffer of each. K_{t+1} loads while S_t's exchange,
// its softmax and P.V_{t-1} run, V_t while S_{t+1} runs. A producer
// warpgroup issues the TMA loads, K's from one thread and V's from
// another, each waiting only for its own buffer's release (4-D tensor
// maps (D, H, S, B), boxes of 64 values of D by 64 rows, 128-byte
// swizzled, rows past S zero-filled and the kv tail masked to -inf), and
// gives its registers to the consumers (setmaxnreg 40 / 232). A tile
// moves ~384 KB through shared memory (K and V in, Q and K to the Q K^T
// products, the partial-S exchange, V to the P.V products) against 4 M
// multiply-adds, so at 128 bytes a clock an SM the shared-memory port,
// not L2 (clusters of two sharing each tile by TMA multicast measured
// slower) or the tensor cores, sets the pace (PERF.md).
//
// Filling the card: one block a (q block of 64 rows, head, batch), so
// (1,16384,1x512) makes 256 blocks, 1.94 waves on 132 SMs, but
// (1,4096,1x512) only 64. Where the grid leaves the card's last wave
// emptier, the wrapper splits the kv walk (ops/flash_attention.py:
// `kv_splits`): each split writes its normalised partial O and lse in f32
// and flash_attention.cu's combine kernel merges them into bf16 out.

#include "common.cuh"
#include "flash_attention.cuh"
#include "sm90.cuh"

namespace vst {
namespace {

using namespace sm90;

template <int D>
struct WideCfg {
  static constexpr int BR = 64;   // query rows a block, shared by both
  static constexpr int BC = 64;   // keys a kv tile
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // O's columns: [0, D0) in consumer 0, [D0, D) in consumer 1
  static constexpr int D0 = 64 * ((D + 127) / 128);
  static constexpr int D1 = D - D0;
  // S's K steps (16 values of D each): half to each consumer
  static constexpr int KSTEPS = D / 16;
  static constexpr uint32_t PANEL = 64 * 128;  // 64 rows of 64 bf16
  static constexpr uint32_t Q_BYTES = PANEL * (D / 64);
  static constexpr uint32_t KV_BYTES = PANEL * (D / 64);  // K or V tile
  static constexpr uint32_t X_BYTES = BR * BC * 4;  // one partial S, f32
  static constexpr size_t OFF_K = Q_BYTES;
  static constexpr size_t OFF_V = OFF_K + KV_BYTES;
  static constexpr size_t OFF_X = OFF_V + KV_BYTES;
  static constexpr size_t OFF_BAR = OFF_X + 2 * X_BYTES;
  // barriers: Q, full K, full V, empty K, empty V; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 8 * 5 + 1024;
  static_assert(D % 64 == 0 && D >= 320 && D <= 512, "head dim");
  static_assert(KSTEPS % 2 == 0, "S's K steps split in two");
  static_assert(D0 % 64 == 0 && D0 <= 256 && D1 > 0 && D1 <= 256 &&
                    D1 % 64 == 0,
                "O's column split");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536,
                "registers");
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

// Named barriers of the two consumer warpgroups (256 threads): both
// partial S tiles written; both read (the tiles may be written again).
constexpr int kBarWritten = 1, kBarRead = 2;

// One consumer warpgroup's release of a K or V tile: lane 0 of each of
// its warps arrives on `bar` (which counts the consumer warps).
__device__ __forceinline__ void warps_release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Keeps the compiler from hoisting what is computed from `addr` out of a
// loop: the K steps' descriptors, kept live across the tile loop, would
// take 32 registers that the overlapped P.V product needs.
__device__ __forceinline__ uint32_t opaque(uint32_t addr) {
  asm volatile("" : "+r"(addr));
  return addr;
}

// This warpgroup's partial S (64 x 64 keys) = Q K^T over K steps [KK0,
// KK1), both K-major in shared memory; landed on return.
template <int KK0, int KK1>
__device__ __forceinline__ void partial_s(float (&s)[32], uint32_t q_addr,
                                          uint32_t k_addr) {
  constexpr uint32_t PANEL = 64 * 128;
  q_addr = opaque(q_addr);
  k_addr = opaque(k_addr);
  fence_regs<32>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = KK0; kk < KK1; ++kk)
    wgmma_ss<64>(s, desc_kmajor(q_addr, PANEL, kk),
                 desc_kmajor(k_addr, PANEL, kk), kk > KK0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);
}

// Adds the other warpgroup's partial S to this one's through shared
// memory: each thread's accumulator registers are the same (row, key)
// elements in both warpgroups, stored as 8 float4 at a stride of 128
// threads (conflict-free). `again`: the tiles were exchanged before, so
// both warpgroups must first have read the last ones.
__device__ __forceinline__ void exchange_s(float (&s)[32], float4* mine,
                                           const float4* other, int tid,
                                           bool again) {
  if (again) named_sync(kBarRead, 256);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mine[j * 128 + tid] =
        make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  named_sync(kBarWritten, 256);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 r = other[j * 128 + tid];
    s[4 * j] += r.x;
    s[4 * j + 1] += r.y;
    s[4 * j + 2] += r.z;
    s[4 * j + 3] += r.w;
  }
}

// Issues O (64 x DC) += P V[:, part] (P from registers, V MN-major).
template <int DC>
__device__ __forceinline__ void pv_issue(float (&o)[DC / 2],
                                         uint32_t (&p)[4][4],
                                         uint32_t v_addr) {
  v_addr = opaque(v_addr);
  fence_regs<DC / 2>(o);
  fence_p<4>(p);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs_vt<DC>(o, p[j], desc_mnmajor(v_addr, 64 * 128, j), 1);
  wgmma_commit();
}

template <int DC>
__device__ __forceinline__ void pv_wait(float (&o)[DC / 2],
                                        uint32_t (&p)[4][4]) {
  wgmma_wait<0>();
  fence_regs<DC / 2>(o);
  fence_p<4>(p);
}

// O shrinks only where a row's max rose (elsewhere corr is exactly 1):
// past the first tiles most warps skip the DC / 2 multiplies.
template <int DC>
__device__ __forceinline__ void rescale(float (&o)[DC / 2],
                                        const float (&corr)[2]) {
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
  }
}

// One consumer warpgroup `C` (0 or 1): O columns [COL0, COL0 + DC), S's K
// steps [C * KSTEPS / 2, (C + 1) * KSTEPS / 2).
template <int D, int C>
__device__ __forceinline__ void wide_consumer(unsigned char* smem,
                                              uint64_t* bar_q,
                                              uint64_t* full_k,
                                              uint64_t* full_v,
                                              uint64_t* empty_k,
                                              uint64_t* empty_v,
                                              const SplitArgs& args, int q0,
                                              int h, int b, int split,
                                              int t0, int t1) {
  using Cfg = WideCfg<D>;
  constexpr int BC = Cfg::BC;
  static_assert(BC == 64, "the helpers above take 64-key tiles");
  constexpr int DC = C == 0 ? Cfg::D0 : Cfg::D1;
  constexpr int COL0 = C == 0 ? 0 : Cfg::D0;
  constexpr int KS = Cfg::KSTEPS / 2;
  const FlashArgs& a = args.a;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t q_addr = smem_u32(smem);
  const uint32_t k_addr = smem_u32(smem + Cfg::OFF_K);
  // this warpgroup's V columns start on panel COL0 / 64
  const uint32_t v_addr = smem_u32(smem + Cfg::OFF_V) +
                          (COL0 / 64) * Cfg::PANEL;
  float4* x_mine =
      reinterpret_cast<float4*>(smem + Cfg::OFF_X + C * Cfg::X_BYTES);
  const float4* x_other = reinterpret_cast<const float4*>(
      smem + Cfg::OFF_X + (1 - C) * Cfg::X_BYTES);
  const float sl2 = a.scale * kLog2e;

  float o[DC / 2];
  float s[BC / 2];
  uint32_t p[BC / 16][4];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) s[i] = 0.f;
  // rows g and g + 8 of this warp's 16: running max (raw logits) and this
  // thread's share of the running sum, the same in both warpgroups
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float corr[2];

  // the first tile: S_t0, its softmax, P_t0 (O is still zero)
  mbar_wait(bar_q, 0);
  mbar_wait(full_k, 0);
  partial_s<C * KS, (C + 1) * KS>(s, q_addr, k_addr);
  warps_release(empty_k, lane);
  exchange_s(s, x_mine, x_other, tid, false);
  softmax_tile<BC>(s, m_i, l_i, corr, t0 * BC, a.seq_k, sl2);
  pack_a<BC>(p, s);

  // each next tile: S_t lands, then O += P_{t-1} V_{t-1} is issued and S_t
  // is exchanged and its softmax runs while that product is in flight
  for (int t = t0 + 1; t < t1; ++t) {
    const uint32_t ph = (t - t0) & 1;
    mbar_wait(full_k, ph);
    partial_s<C * KS, (C + 1) * KS>(s, q_addr, k_addr);
    warps_release(empty_k, lane);
    mbar_wait(full_v, ph ^ 1);
    pv_issue<DC>(o, p, v_addr);
    exchange_s(s, x_mine, x_other, tid, true);
    softmax_tile<BC>(s, m_i, l_i, corr, t * BC, a.seq_k, sl2);
    pv_wait<DC>(o, p);
    warps_release(empty_v, lane);
    rescale<DC>(o, corr);
    pack_a<BC>(p, s);
  }
  // the last P.V
  mbar_wait(full_v, (t1 - 1 - t0) & 1);
  pv_issue<DC>(o, p, v_addr);
  pv_wait<DC>(o, p);
  warps_release(empty_v, lane);

  // epilogue: the quad's shares of each row sum, then this warpgroup's
  // columns of out (or of this split's partial) and, from warpgroup 0,
  // the lse
  const long long rows = (long long)a.batch * a.heads * a.seq_q;
  const long long bh = (long long)b * a.heads + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= a.seq_q) continue;
    l = l == 0.f ? 1.f : l;
    const float inv = __frcp_rn(l);
    const float lse = (m_i[r] * sl2 + log2f(l)) * (1.0f / kLog2e);
    if (args.kv_splits == 1) {
      bf16* orow = static_cast<bf16*>(a.o) +
                   ((long long)b * a.seq_q + row) * a.heads * D + h * D +
                   COL0 + t4 * 2;
#pragma unroll
      for (int i = 0; i < DC / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + i * 8) = pack_bf16x2(
            o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (C == 0 && t4 == 0) a.lse[bh * a.seq_q + row] = lse;
    } else {
      float* prow = args.part + (split * rows + bh * a.seq_q + row) * D +
                    COL0 + t4 * 2;
#pragma unroll
      for (int i = 0; i < DC / 8; ++i)
        *reinterpret_cast<float2*>(prow + i * 8) = make_float2(
            o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
      if (C == 0 && t4 == 0)
        args.part[rows * D * args.kv_splits + split * rows + bh * a.seq_q +
                  row] = lse;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const SplitArgs args) {
  using Cfg = WideCfg<D>;
  constexpr int BC = Cfg::BC;
  static_assert(Cfg::THREADS == 384, "the launch bounds");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + Cfg::OFF_BAR);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = bar_q + 2;
  uint64_t* empty_k = bar_q + 3;
  uint64_t* empty_v = bar_q + 4;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * Cfg::BR;
  const int split = blockIdx.y % args.kv_splits;
  const int h = blockIdx.y / args.kv_splits, b = blockIdx.z;
  const int n_tiles = (args.a.seq_k + BC - 1) / BC;
  const int t0 = split * args.tiles_per_split;
  const int t1 = min(n_tiles, t0 + args.tiles_per_split);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    mbar_init(empty_k, 8);  // one arrival per consumer warp
    mbar_init(empty_v, 8);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<Cfg::PRODUCER_REGS>();
    // thread 0 loads Q and the K tiles, thread 32 the V tiles: each waits
    // only for its own buffer's release
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar_q, Cfg::Q_BYTES);
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_load_4d(smem + p * Cfg::PANEL, &tq, bar_q, p * 64, h, q0, b);
      for (int t = t0; t < t1; ++t) {
        mbar_wait(empty_k, ((t - t0) & 1) ^ 1);
        mbar_arrive_tx(full_k, Cfg::KV_BYTES);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(smem + Cfg::OFF_K + p * Cfg::PANEL, &tk, full_k,
                      p * 64, h, t * BC, b);
      }
    } else if (threadIdx.x == 32) {
      for (int t = t0; t < t1; ++t) {
        mbar_wait(empty_v, ((t - t0) & 1) ^ 1);
        mbar_arrive_tx(full_v, Cfg::KV_BYTES);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(smem + Cfg::OFF_V + p * Cfg::PANEL, &tv, full_v,
                      p * 64, h, t * BC, b);
      }
    }
    return;
  }
  // ------------------------------------------------------ consumers
  setmaxnreg_inc<Cfg::CONSUMER_REGS>();
  if (wg == 1)
    wide_consumer<D, 0>(smem, bar_q, full_k, full_v, empty_k, empty_v, args,
                        q0, h, b, split, t0, t1);
  else
    wide_consumer<D, 1>(smem, bar_q, full_k, full_v, empty_k, empty_v, args,
                        q0, h, b, split, t0, t1);
}

template <int D>
int launch(const FlashArgs& a, int kv_splits, float* part,
           cudaStream_t stream) {
  using Cfg = WideCfg<D>;
  const SplitArgs args = split_args(a, (a.seq_k + Cfg::BC - 1) / Cfg::BC,
                                    kv_splits, part);
  if (args.kv_splits < 0) return -2;
  static std::atomic<uint64_t> smem_set{0};
  const int dev = current_device();
  if (dev < 0) return -dev;
  CUtensorMap tq, tk, tv;
  int e = qkv_maps(a, D, Cfg::BR, Cfg::BC, &tq, &tk, &tv);
  if (e != 0) return e;
  auto kern = flash_fwd_sm90_wide_kernel<D>;
  e = allow_smem_once(kern, (int)Cfg::SMEM, dev, smem_set);
  if (e != 0) return e;
  dim3 grid((a.seq_q + Cfg::BR - 1) / Cfg::BR, a.heads * kv_splits,
            a.batch);
  kern<<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(tq, tk, tv, args);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_fwd_sm90_wide(int head_dim, const FlashArgs& a, int kv_splits,
                        float* part, cudaStream_t stream) {
  switch (head_dim) {
    case 320: return launch<320>(a, kv_splits, part, stream);
    case 384: return launch<384>(a, kv_splits, part, stream);
    case 448: return launch<448>(a, kv_splits, part, stream);
    case 512: return launch<512>(a, kv_splits, part, stream);
    default: return -2;
  }
}

}  // namespace vst
