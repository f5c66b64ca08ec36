// K1 (bf16, head_dim 64 / 128 / 192 / 256): flash-attention forward on
// Hopper's warpgroup products and tensor memory accelerator.
//
// Replaces the JAX package's Pallas kernels ops/flash_attention.py
// `_attn_kernel_packed_single` / `_attn_kernel_packed` (packed heads,
// d = 64) and `_attn_kernel` (K6, the unpacked kernel of head dims the TPU
// cannot pack, such as d = 192), for bf16 inputs. bf16 d >= 320 runs on
// flash_attention_wide.cu, fp32 on flash_attention_f32.cu (d = 512) and
// flash_attention.cu (the other head dims).
//
// Same function as K1's other routes: per (batch, head), out =
// softmax(q k^T * scale) v with f32 logits, running max and sum, P
// rounded to bf16 for the P.V product and O once at the output; lse in
// natural-log units. q, k and v are read as (B, S, H, D) strided views
// (the fused (B, S, 3*H*D) projection in place); out is (B, Sq, H*D), lse
// (B, H, Sq) f32.
//
// Bound on the H100: ~4 * Sq * Sk * D flops against ~4 * S * D * 2 bytes
// a head, so at the UNet's S >= 1024 tensor-core throughput bounds it.
// Common to both kernels below:
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
//   is also masked to -inf). The host keeps the encoded maps and the
//   shared-memory attribute (sm90.cuh), so a repeated call only launches.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues
//   the TMA loads into rings completed on mbarriers, K apart from V so
//   that Q K^T starts before V lands) and gives its registers to the
//   consumer warpgroups (setmaxnreg), each of which owns 64 query rows.
//   Consumers hand stages back on "empty" barriers.
//
// d = 64 (every UNet self-attention), `flash_fwd_sm90_d64_kernel`. There a
// score costs 4 * 64 = 256 tensor flops and one exp2, so the softmax's
// MUFU and FP32 work per score is as large as its share of the products,
// and at the serving paths' 8-32 kv tiles a block the per-block fixed
// costs count. So:
// - Persistent blocks: one per SM walks the (q block, head, batch) tiles
//   at a stride of the grid, q block fastest, so a (batch, head)'s K and V
//   stay in L2. Q has two buffers and the K/V ring runs on across tiles:
//   the producer loads the next tile's Q and first stages while the
//   consumers finish the current one.
// - Three consumer warpgroups (192 query rows a tile; setmaxnreg 32 and
//   160 a thread): more warps on each SM sub-partition to hide the
//   softmax's latency, and each K/V stage serves three warpgroups.
// - Within a warpgroup, S_t = Q K_t^T is issued together with O += P_{t-1}
//   V_{t-1}; the softmax of S_t runs while that P.V product is in flight
//   (wgmma_wait<1>), and O is rescaled once it has landed. Registers: S 64
//   floats, P 32, O 32 a thread.
// - Ping-pong: named barriers make the warpgroups take turns issuing
//   their products, so one warpgroup's softmax runs while another's
//   products keep the tensor cores busy.
// - Every exp2 stays on MUFU and O is rescaled at every tile: taking a
//   quarter of the exp2s on the FP32 pipes (a Cody-Waite split and a
//   cubic) measured slower, and keeping a row's max until it rises by
//   2^8 no faster, as the FP32 pipes and issue slots, not MUFU, limit the
//   softmax here (PERF.md).
// - The epilogue stages each warpgroup's O rows in shared memory (128-byte
//   swizzle, conflict-free) and writes them as coalesced 16-byte stores.
//
// d >= 128, `flash_fwd_sm90_kernel<D>`: one block per (q block, head,
// batch), two consumer warpgroups (setmaxnreg 40 and 232); within a
// warpgroup the two products and the softmax run in turn and the two
// warpgroups' turns interleave on the SM. Tiles by D so that registers
// fit: BC = 128 keys at D = 128 (S 64 f32 a thread, O 64), BC = 64 at D >=
// 192 (S 32, O 96 / 128); three ring stages, two at D = 256 (shared
// memory).

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

// the persistent d = 64 kernel's tiles for its NC = 3 consumer
// warpgroups (64 query rows each): two Q buffers, a four-stage K/V ring,
// each consumer warpgroup's 64 x 64 output staging tile; the registers a
// thread keeps after setmaxnreg (producer, consumers: S 64, P 32 and O 32
// of the consumers' 160)
struct D64Cfg {
  static constexpr int NC = 3, D = 64, BR = 64 * NC, BC = 128, NST = 4;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 160;
  static constexpr uint32_t Q_BYTES = BR * 128;   // one 64-wide panel
  static constexpr uint32_t KV_BYTES = BC * 128;  // K or V tile
  static constexpr uint32_t O_BYTES = 64 * 128;   // a warpgroup's rows
  static constexpr size_t OFF_K = 2 * Q_BYTES;
  static constexpr size_t OFF_V = OFF_K + NST * KV_BYTES;
  static constexpr size_t OFF_O = OFF_V + NST * KV_BYTES;
  static constexpr size_t OFF_BAR = OFF_O + NC * O_BYTES;
  // barriers: full Q[2], empty Q[2], full K[NST], full V[NST],
  // empty[NST]; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 8 * (4 + 3 * NST) + 1024;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * NC <= 65536,
                "registers");
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

// O (64 x D) += P V over BC / 16 K steps; P from registers, V MN-major.
// accumulate = 0 overwrites O with the product.
template <int D, int BC>
__device__ __forceinline__ void pv_product(float* o,
                                           uint32_t (&p)[BC / 16][4],
                                           uint32_t v_addr,
                                           uint32_t v_panel,
                                           int accumulate = 1) {
#pragma unroll
  for (int j = 0; j < BC / 16; ++j)
    wgmma_rs_vt<D>(o, p[j], desc_mnmajor(v_addr, v_panel, j),
                   j > 0 ? 1 : accumulate);
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

// One consumer warpgroup's hand-off: lane 0 of each of its warps arrives
// on `bar` (which counts every consumer warp).
__device__ __forceinline__ void warps_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// The persistent d = 64 kernel (see the head of the file). n_work =
// q blocks x heads x batch tiles, walked at a stride of the grid.
__global__ void __launch_bounds__(512, 1)
    flash_fwd_sm90_d64_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const FlashArgs a, int n_work) {
  using C = D64Cfg;
  constexpr int NC = C::NC, D = C::D, BC = C::BC, NST = C::NST;
  static_assert(C::THREADS == 512, "the launch bounds");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty_q = full_q + 2;
  uint64_t* full_k = empty_q + 2;
  uint64_t* full_v = full_k + NST;
  uint64_t* empty = full_v + NST;

  const int wg = threadIdx.x / 128;
  const int n_qb = (a.seq_q + C::BR - 1) / C::BR;
  const int n_kv = (a.seq_k + BC - 1) / BC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_q[i], 1);
      mbar_init(&empty_q[i], 4 * NC);  // one arrival per consumer warp
    }
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // kv tiles this block has loaded, over all its tiles
      int n = 0;
      for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x, ++n) {
        const int q0 = (tile % n_qb) * C::BR;
        const int h = (tile / n_qb) % a.heads, b = tile / n_qb / a.heads;
        const int qb = n & 1;
        mbar_wait(&empty_q[qb], ((n >> 1) & 1) ^ 1);
        mbar_arrive_tx(&full_q[qb], C::Q_BYTES);
        tma_load_4d(smem + qb * C::Q_BYTES, &tq, &full_q[qb], 0, h, q0, b);
        for (int t = 0; t < n_kv; ++t, ++it) {
          const int st = it % NST;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_tx(&full_k[st], C::KV_BYTES);
          tma_load_4d(smem + C::OFF_K + st * C::KV_BYTES, &tk, &full_k[st],
                      0, h, t * BC, b);
          mbar_arrive_tx(&full_v[st], C::KV_BYTES);
          tma_load_4d(smem + C::OFF_V + st * C::KV_BYTES, &tv, &full_v[st],
                      0, h, t * BC, b);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int c = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t k_addr = smem_u32(smem + C::OFF_K);
  const uint32_t v_addr = smem_u32(smem + C::OFF_V);
  unsigned char* stage = smem + C::OFF_O + c * C::O_BYTES;
  const float sl2 = a.scale * kLog2e;
  // named barriers: 1 + c is this warpgroup's turn to issue products
  // (the previous one arrives on it once it has issued its own), 1 + NC + c
  // its epilogue's
  const int my_turn = 1 + c, next_turn = 1 + (c + 1) % NC;
  const int epilogue_bar = 1 + NC + c;

  float o[D / 2];
  float s[BC / 2];
  uint32_t p[BC / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < BC / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0u;

  // the first warpgroup issues first
  if (c == NC - 1) named_arrive(1, 256);

  int it = 0;  // kv tiles this warpgroup has consumed, over all its tiles
  int n = 0;
  for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x, ++n) {
    const int q0 = (tile % n_qb) * C::BR;
    const int h = (tile / n_qb) % a.heads, b = tile / n_qb / a.heads;
    const int qb = n & 1;
    // this warpgroup's 64 rows start 64 rows into the Q tile
    const uint32_t q_addr = smem_u32(smem + qb * C::Q_BYTES) + c * 64 * 128;
    // rows g and g + 8 of this warp's 16: running max (raw logits) and
    // this thread's share of the running sum
    float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
    float corr[2];

    // S_0 = Q K_0^T, its softmax, P_0
    int st = it % NST;
    uint32_t ph = (it / NST) & 1;
    mbar_wait(&full_q[qb], (n >> 1) & 1);
    mbar_wait(&full_k[st], ph);
    named_sync(my_turn, 256);
    fence_regs<BC / 2>(s);
    wgmma_fence();
    qk_product<D, BC>(s, q_addr, k_addr + st * C::KV_BYTES, C::Q_BYTES,
                      C::KV_BYTES);
    wgmma_commit();
    named_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs<BC / 2>(s);
    if (n_kv == 1) warps_arrive(&empty_q[qb], lane);
    softmax_tile<BC>(s, m_i, l_i, corr, 0, a.seq_k, sl2);
    pack_a<BC>(p, s);

    // S_t = Q K_t^T issued with O += P_{t-1} V_{t-1}; the softmax of S_t
    // runs while the P.V product is in flight
    for (int t = 1; t < n_kv; ++t) {
      const int pst = st;
      const uint32_t pph = ph;
      ++it;
      st = it % NST;
      ph = (it / NST) & 1;
      mbar_wait(&full_k[st], ph);
      mbar_wait(&full_v[pst], pph);
      named_sync(my_turn, 256);
      fence_regs<BC / 2>(s);
      fence_regs<D / 2>(o);
      fence_p<BC / 16>(p);
      wgmma_fence();
      qk_product<D, BC>(s, q_addr, k_addr + st * C::KV_BYTES, C::Q_BYTES,
                        C::KV_BYTES);
      wgmma_commit();
      // the first P.V product overwrites O
      pv_product<D, BC>(o, p, v_addr + pst * C::KV_BYTES, C::KV_BYTES,
                        t > 1);
      wgmma_commit();
      named_arrive(next_turn, 256);
      wgmma_wait<1>();
      fence_regs<BC / 2>(s);
      if (t == n_kv - 1) warps_arrive(&empty_q[qb], lane);
      softmax_tile<BC>(s, m_i, l_i, corr, t * BC, a.seq_k, sl2);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_p<BC / 16>(p);
      warps_arrive(&empty[pst], lane);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
      pack_a<BC>(p, s);
    }

    // the last P.V product
    mbar_wait(&full_v[st], ph);
    named_sync(my_turn, 256);
    fence_regs<D / 2>(o);
    fence_p<BC / 16>(p);
    wgmma_fence();
    pv_product<D, BC>(o, p, v_addr + st * C::KV_BYTES, C::KV_BYTES,
                      n_kv > 1);
    wgmma_commit();
    named_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_p<BC / 16>(p);
    warps_arrive(&empty[st], lane);
    ++it;

    // epilogue: the quad's shares of each row sum, lse, then O through
    // this warpgroup's staging tile (64 rows of 128 bytes, 16-byte chunk
    // c of row r at chunk c ^ (r % 8): conflict-free both ways)
    const int row0 = q0 + c * 64;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = l == 0.f ? 1.f : l;
      inv[r] = __frcp_rn(l);
      const int row = row0 + warp * 16 + g + r * 8;
      if (t4 == 0 && row < a.seq_q)
        a.lse[((long long)b * a.heads + h) * a.seq_q + row] =
            (m_i[r] * sl2 + log2f(l)) * (1.0f / kLog2e);
    }
    // every thread of the warpgroup has read the last tile's staging
    named_sync(epilogue_bar, 128);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = warp * 16 + g + r * 8;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(stage + rr * 128 + ((i ^ (rr & 7)) << 4) +
                                     t4 * 4) =
            pack_bf16x2(o[4 * i + 2 * r] * inv[r],
                        o[4 * i + 2 * r + 1] * inv[r]);
    }
    named_sync(epilogue_bar, 128);
    bf16* ob = static_cast<bf16*>(a.o);
    const long long o_ss = (long long)a.heads * D;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = k * 16 + tid / 8, ch = tid % 8;
      if (row0 + rr < a.seq_q)
        *reinterpret_cast<uint4*>(
            ob + ((long long)b * a.seq_q + row0 + rr) * o_ss + h * D +
            ch * 8) =
            *reinterpret_cast<const uint4*>(stage + rr * 128 +
                                            ((ch ^ (rr & 7)) << 4));
    }
  }
}

int launch_d64(const FlashArgs& a, cudaStream_t stream) {
  using C = D64Cfg;
  auto kern = flash_fwd_sm90_d64_kernel;
  static std::atomic<uint64_t> smem_set{0};
  const int dev = current_device();
  if (dev < 0) return -dev;
  const int sms = sm_count(dev);
  if (sms < 1) return -2;
  const long long n_work = (long long)((a.seq_q + C::BR - 1) / C::BR) *
                           a.heads * a.batch;
  if (n_work > 0x7fffffff) return -2;
  CUtensorMap tq, tk, tv;
  int e = qkv_maps(a, C::D, C::BR, C::BC, &tq, &tk, &tv);
  if (e != 0) return e;
  e = allow_smem_once(kern, (int)C::SMEM, dev, smem_set);
  if (e != 0) return e;
  const int grid = n_work < sms ? (int)n_work : sms;
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a, (int)n_work);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using C = Sm90Cfg<D>;
  static std::atomic<uint64_t> smem_set{0};
  const int dev = current_device();
  if (dev < 0) return -dev;
  CUtensorMap tq, tk, tv;
  int e = qkv_maps(a, D, C::BR, C::BC, &tq, &tk, &tv);
  if (e != 0) return e;
  auto kern = flash_fwd_sm90_kernel<D>;
  e = allow_smem_once(kern, (int)C::SMEM, dev, smem_set);
  if (e != 0) return e;
  dim3 grid((a.seq_q + C::BR - 1) / C::BR, a.heads, a.batch);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

int qkv_maps(const FlashArgs& a, int d, int q_rows, int kv_rows,
             CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv) {
  using sm90::cached_bshd_tensor_map;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  int e = cached_bshd_tensor_map(tq, BF16, 2, a.q, a.batch, a.seq_q,
                                 a.heads, d, a.q_sb, a.q_ss, a.q_sh, 64,
                                 q_rows, SW);
  if (e == 0)
    e = cached_bshd_tensor_map(tk, BF16, 2, a.k, a.batch, a.seq_k, a.heads,
                               d, a.k_sb, a.k_ss, a.k_sh, 64, kv_rows, SW);
  if (e == 0)
    e = cached_bshd_tensor_map(tv, BF16, 2, a.v, a.batch, a.seq_k, a.heads,
                               d, a.v_sb, a.v_ss, a.v_sh, 64, kv_rows, SW);
  return e == 0 ? 0 : e < 0 ? e : -1000 - e;  // a CUresult from the encode
}

int flash_fwd_sm90(int head_dim, const FlashArgs& a, cudaStream_t stream) {
  if (a.seq_k < 1) return -2;
  switch (head_dim) {
    case 64: return launch_d64(a, stream);
    case 128: return launch<128>(a, stream);
    case 192: return launch<192>(a, stream);
    case 256: return launch<256>(a, stream);
    default: return -2;
  }
}

}  // namespace vst
