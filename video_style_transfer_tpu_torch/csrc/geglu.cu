// K2: fused GEGLU projection for Hopper.
//
// Replaces the JAX package's Pallas kernel ops/geglu.py `_make_kernel`
// (launched by `_fwd_call`).
//
// Computes out[m, j] = (x[m] . W[j] + b[j]) * gelu(x[m] . W[j + inner] +
// b[j + inner]) for x (M, C) and W (2*inner, C) (PyTorch's linear
// layout), reading the h rows [j] and the gate rows [j + inner] of W in
// place and writing only the gated (M, inner) half: f32 products and
// bias, the gate in f32, one rounding at the output. The gate is chosen
// by the caller (erf5 / cdf3 / poly14, the JAX package's `_GATES`).
//
// Bound on the H100: 4*M*C*inner flops over (M*C + 2*C*inner + M*inner)
// elements of traffic is hundreds of flops per byte at the UNet shapes
// (C = 320..1280, M = 2048..524288): tensor-core bound in both dtypes
// (fp32 at three TF32 products a product, below). The fusion saves the
// (M, 2*inner) intermediate's write and re-read, which a separate matmul
// + gate would pay.
//
// bf16, `geglu_bf16_kernel`: a GEMM (N = 2 * inner) with an epilogue
// (bias, gate, product) of about half its products' time at C = 320:
// - wgmma from shared memory. A stage holds a 128-row x tile and, side by
//   side, the 64 h rows and the 64 gate rows of W for one column tile, 64
//   K values each (128-byte swizzled panels, both K-major). Per 16-deep K
//   step two m64n128k16 products (rows 0-63 and 64-127 of x, one B
//   descriptor over the 128 W rows) give a 128 x 64 tile's h and gate
//   accumulators; in the accumulator layout h column j and gate column j
//   sit in the same thread, so the gate is applied in registers.
// - TMA loads through four tensor maps: x as (1, M, 1, C), W's h half as
//   (1, inner, 1, C) at w, its gate half as the same at w + inner * C (so
//   a column tile past `inner` reads zeros, never the other half), out as
//   (1, M, 1, inner). Rows past M, K past C and columns past inner are
//   zero-filled on load and clipped on store: C and inner need only be
//   multiples of 8. The host keeps the encoded maps and the shared-memory
//   attribute (sm90.cuh), so a repeated call only launches.
// - What bounds it: the bytes each SM pulls from L2 (32 KB a stage for 1 M
//   MACs), not the tensor cores. So blocks run in clusters of two on two
//   row tiles of one column tile: each loads its own x tile and one half
//   of W (h rows on rank 0, gate rows on rank 1) into both blocks by TMA
//   multicast, 24 KB a stage from L2 instead of 32. A stage is refilled
//   once the consuming warpgroups of both blocks have released it (they
//   arrive on both blocks' "empty" barriers).
// - Warp-specialised and persistent: one block an SM; the cluster pairs
//   walk the output tiles at a stride of their count, column tile
//   fastest, so the blocks in flight share x rows (and all of W stays in
//   L2). A producer warpgroup (one thread) keeps a six-stage ring full on
//   mbarriers; the ring runs on across tiles, so the next tile's loads are
//   in flight during an epilogue.
// - Ping-pong: two consumer warpgroups take alternate tiles and turns on
//   named barriers; one issues its whole K loop (releasing each stage as
//   the product after it lands) and hands the turn over, then runs its
//   epilogue while the other's products run. setmaxnreg gives the
//   producer 40 registers a thread and each consumer 232 (128
//   accumulators). At C = 320 the gate still adds about a quarter to the
//   kernel's time (PERF.md): the overlap is partial there.
// - Epilogue: the bias is added in f32, the gate runs in f32 with its
//   division and exp2 on MUFU (rcp.approx, ex2.approx: ulp-level, far
//   under bf16's rounding), the bf16 tile is staged in shared memory in
//   the 128-byte swizzle (conflict-free) and written by one TMA store,
//   whose completion is awaited only before the next tile's staging.
//
// fp32, `geglu_f32_kernel`: the same products on the TF32 tensor cores at
// 3xTF32, within 1e-5 of the plain version. An exact-fp32 kernel on the
// FMA pipes (67 TF/s) would need over 71 % of their peak to match cuBLAS's
// fp32 GEMM; the TF32 wgmma (495 TF/s) at three products a product bounds
// the call at 3 * 4*M*C*inner / 494.7e12 s (5.21 ms at each UNet shape).
// - The split: every operand a is hi = rna_tf32(a) plus lo = rna_tf32(a -
//   hi), and a product a b is a.lo b.hi + a.hi b.lo + a.hi b.hi.
//   geglu_split_w_kernel writes W.hi and W.lo into the caller's scratch
//   once a call (4 inner C floats: 157 MB of traffic at spatial level 2,
//   against the kernel's 859 GF);
//   x is split in registers: TF32 wgmma takes A from registers, and both
//   operands are K-major, the only layout TF32 takes in shared memory.
// - Tensor-core sums truncate (each product at the size of the sum it
//   adds into), so each stage's products (32 K values, twelve products)
//   are summed from zero, its eight small ones (x.lo W.hi, x.hi W.lo)
//   before its four x.hi W.hi, and added to the tile's total by FADD: two
//   accumulator sets of 64 floats a thread, which is why a consumer
//   warpgroup owns 64 rows (one m64n128k8) and not 128. On an H100 at
//   spatial level 2 (`cli/profile_step.py --k2_restarts`: distance from
//   the float64 evaluation of the plain version, whose fp32 evaluation,
//   cuBLAS's fp32 GEMM, reads 2.8e-5), restarts of 32 K values read
//   7.1e-6 in this order against 1.02e-5 with each K step's three
//   products in turn; restarts of 16 or 8 were less exact (more rounded
//   adds) and 22-24 % slower (a wait each).
// - Persistent, warp-specialised like the bf16 kernel: a producer warp
//   keeps a four-stage TMA ring full (48 KB a stage: the 128-row x tile,
//   W.hi and W.lo's 64 h and 64 gate rows), both consumer warpgroups take
//   rows 0-63 and 64-127 of the same tile from it (one W tile for 128
//   rows: 32 bytes from L2 a tensor-core clock). The tiles are walked in
//   groups of 16 row tiles, so that the W columns in flight stay in L2.
// - Epilogue: bias and gate in f32 with IEEE division and exp2, written
//   from registers (8 bytes a row and column pair, whole sectors).
// Rows past M, K past C and columns past inner are zero-filled by TMA, as
// in the bf16 kernel (C and inner multiples of 8).

#include <cstddef>

#include "common.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"

namespace vst {

// The arguments of one K2 call as ops/geglu.py packs them (`_POINTERS`,
// `_LAYOUT`, `_GATE`: "<6Q", "<5i", "<i"): pointers and the stream, the
// device the call is for, then the scalars.
struct GegluCall {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  void* wsplit;  // fp32: scratch of 4 inner C floats for W.hi, W.lo
  void* stream;
  int device, dtype, m, c, inner, gate;
};

namespace {

using namespace sm90;

constexpr int kGateErf5 = 0;
constexpr int kGateCdf3 = 1;
constexpr int kGatePoly14 = 2;

// 1/x and 2^x: on MUFU where FAST (the bf16 kernel), IEEE otherwise
template <bool FAST>
__device__ __forceinline__ float recip(float x) {
  if constexpr (FAST) return rcp(x);
  else return 1.f / x;
}

template <bool FAST>
__device__ __forceinline__ float exp2_(float x) {
  if constexpr (FAST) return ex2(x);
  else return exp2f(x);
}

// Abramowitz-Stegun 7.1.26 erf (the JAX package's `_erf_as`)
template <bool FAST>
__device__ __forceinline__ float erf_as(float x) {
  const float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = recip<FAST>(1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = exp2_<FAST>(-(ax * ax) * kLog2e);
  return sign * (1.f - poly * e);
}

template <bool FAST>
__device__ __forceinline__ float gelu_erf5(float x) {
  return 0.5f * x * (1.f + erf_as<FAST>(x * 0.70710678118654752f));
}

// direct 3-term normal CDF (Abramowitz-Stegun 26.2.16), `_gelu_cdf3`
template <bool FAST>
__device__ __forceinline__ float gelu_cdf3(float x) {
  const float ax = fabsf(x);
  const float t = recip<FAST>(1.f + 0.33267f * ax);
  const float poly = t * (0.4361836f + t * (-0.1201676f + t * 0.9372980f));
  const float pdf =
      0.3989422804014327f * exp2_<FAST>(-(0.5f * kLog2e) * (ax * ax));
  const float phi_pos = 1.f - pdf * poly;
  const float phi = (x >= 0.f) ? phi_pos : 1.f - phi_pos;
  return x * phi;
}

// clamped Chebyshev-fit erf, `_gelu_poly14`
__device__ __forceinline__ float gelu_poly14(float x) {
  constexpr float kXmax = 5.4f;
  constexpr float kTscale = 2.0f / (5.4f * 5.4f);
  const float c[15] = {
      0.26185622220921656f,  -0.13065609481680923f, 0.09699951875067843f,
      -0.07841408412755317f, 0.06422728013461654f,  -0.051488954314033455f,
      0.03932888845773156f,  -0.027941163343751726f, 0.019183359175576342f,
      -0.01340499669652595f, 0.007504966895981539f, -0.0023944706774313563f,
      0.0016048457692697362f, -0.002049756592036783f, 0.00082965585022015f};
  const float xc = fminf(fmaxf(x, -kXmax), kXmax);
  const float t = xc * xc * kTscale - 1.f;
  float r = c[14];
#pragma unroll
  for (int i = 13; i >= 0; --i) r = r * t + c[i];
  return 0.5f * x * (1.f + xc * r);
}

template <int GATE, bool FAST>
__device__ __forceinline__ float gate_fn(float g) {
  if constexpr (GATE == kGateErf5) return gelu_erf5<FAST>(g);
  else if constexpr (GATE == kGateCdf3) return gelu_cdf3<FAST>(g);
  else return gelu_poly14(g);
}

// ---------------------------------------------------------------- bf16

// The bf16 kernel's tiles. A consumer warpgroup's tile is BM = 128 rows x
// BN = 64 output columns: two m64n128k16 products a 16-deep K step, each
// over BN h and BN gate columns (64 + 64 accumulators a thread). A block
// of a cluster pair loads its x tile and one half of W (h rows: rank 0,
// gate rows: rank 1) into both blocks. The ring holds as many stages as
// shared memory leaves beside the two warpgroups' staging tiles.
struct Bf16Cfg {
  static constexpr int BM = 128, BN = 64, MH = BM / 64, CLUSTER = 2;
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr uint32_t X_BYTES = BM * 128;      // BM rows x 64 K
  static constexpr uint32_t W_BYTES = 2 * BN * 128;  // h rows, gate rows
  static constexpr uint32_t STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr uint32_t OUT_BYTES = BM * BN * 2;  // a bf16 tile
  static constexpr int NST =
      (232448 - 2048 - 2 * OUT_BYTES) / STAGE_BYTES;  // 6
  static constexpr size_t OFF_OUT = (size_t)NST * STAGE_BYTES;
  static constexpr size_t OFF_BAR = OFF_OUT + 2 * OUT_BYTES;
  // barriers: full[NST], empty[NST]; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 16 * NST + 1024;
  static_assert(BN == 64, "one 64-wide panel of output a tile");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536,
                "registers");
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

// One consumer warpgroup's hand-off of a stage: lane 0 of each of its
// warps arrives on `bar` in this block and in its peer (which count the
// four warps of the warpgroup that consumed the stage in each block).
__device__ __forceinline__ void warps_arrive(uint64_t* bar, int lane,
                                             uint32_t peer) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(bar);
    mbar_arrive_cluster(bar, peer);
  }
}

template <int GATE>
__global__ void __launch_bounds__(384, 1)
    geglu_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap th,
                      const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap to,
                      const bf16* __restrict__ bias, int m, int c,
                      int inner) {
  using C = Bf16Cfg;
  constexpr int BM = C::BM, BN = C::BN, MH = C::MH, NST = C::NST;
  constexpr int CL = C::CLUSTER;
  static_assert(C::THREADS == 384, "the launch bounds");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + NST;

  const int wg = threadIdx.x / 128;
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1;
  // a tile is a pair of row tiles (one a block) by a column tile; the
  // clusters walk them at a stride of their count
  const int cl = blockIdx.x / CL, n_cl = gridDim.x / CL;
  const int n_n = (inner + BN - 1) / BN;
  const int n_tiles =  // fits: checked on the host
      ((m + CL * BM - 1) / (CL * BM)) * n_n;
  const int kt_n = (c + 63) / 64;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      // one arrival per consumer warp of the warpgroup that consumed the
      // stage, in each block of the pair
      mbar_init(&empty[i], 4 * CL);
    }
    mbar_init_fence();
  }
  // the peer's barriers are initialised before either block loads
  cluster_sync();

  if (wg == 0) {
    // --------------------------------------------------------- producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // K slices this block has loaded, over all its tiles
      for (int tile = cl; tile < n_tiles; tile += n_cl) {
        const int m0 = ((tile / n_n) * CL + rank) * BM;
        const int n0 = (tile % n_n) * BN;
        for (int k = 0; k < kt_n; ++k, ++it) {
          const int st = it % NST;
          // both blocks' consumers have released the stage
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          unsigned char* s = smem + st * C::STAGE_BYTES;
          // this block's x tile, and W's h rows (rank 0) or gate rows
          // (rank 1) into both blocks
          mbar_arrive_tx(&full[st], C::STAGE_BYTES);
          tma_load_4d(s, &tx, &full[st], k * 64, 0, m0, 0);
          tma_load_4d_multicast(s + C::X_BYTES + rank * BN * 128,
                                rank == 0 ? &th : &tg, &full[st], 0x3,
                                k * 64, 0, n0, 0);
        }
      }
      // the block stays until both blocks' consumers have released every
      // stage: no arrival from the peer is then still to come
      for (int i = 0; i < NST; ++i, ++it)
        mbar_wait(&empty[it % NST], ((it / NST) & 1) ^ 1);
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t ring = smem_u32(smem);
  unsigned char* staging = smem + C::OFF_OUT + cw * C::OUT_BYTES;
  // named barriers: 1 + cw is this warpgroup's turn to issue its K loop
  // (the other arrives on it once it has issued its own), 3 + cw its
  // epilogue's
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  const int epilogue_bar = 3 + cw;

  // each 64-row half's m64n128k16 accumulator: BN h columns, then BN gate
  // columns
  float acc[MH][BN];

  // warpgroup 0 issues first
  if (cw == 1) named_arrive(1, 256);

  int n = cw;  // this block's tile count before this tile
  for (int tile = cl + cw * n_cl; tile < n_tiles; tile += 2 * n_cl, n += 2) {
    const int m0 = ((tile / n_n) * CL + rank) * BM;
    const int n0 = (tile % n_n) * BN;
    int it = n * kt_n;

    // the K loop: each slice's products issued once its stage has landed;
    // the stage before is released once they are in flight (its products
    // have completed)
    named_sync(my_turn, 256);
    for (int k = 0; k < kt_n; ++k, ++it) {
      const int st = it % NST;
      mbar_wait(&full[st], (it / NST) & 1);
      const uint32_t xa = ring + st * C::STAGE_BYTES;
      const uint32_t wa = xa + C::X_BYTES;
#pragma unroll
      for (int r = 0; r < MH; ++r) fence_regs<BN>(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bd = desc_kmajor(wa, C::W_BYTES, kk);
#pragma unroll
        for (int r = 0; r < MH; ++r)
          wgmma_ss<2 * BN>(acc[r],
                           desc_kmajor(xa + r * 64 * 128, C::X_BYTES, kk), bd,
                           (k | kk) != 0);
      }
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int r = 0; r < MH; ++r) fence_regs<BN>(acc[r]);
        warps_arrive(&empty[(it - 1) % NST], lane, peer);
      }
    }
    named_arrive(other_turn, 256);
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < MH; ++r) fence_regs<BN>(acc[r]);
    warps_arrive(&empty[(it - 1) % NST], lane, peer);

    // epilogue: bias and gate in f32, the bf16 tile through this
    // warpgroup's staging tile (BM rows x 128 bytes, 16-byte chunk i of row
    // r at chunk i ^ (r % 8): conflict-free), then one TMA store, which
    // clips rows past M and columns past inner
    if (tid == 0) bulk_wait_read();  // the last tile's store has read it
    named_sync(epilogue_bar, 128);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      float2 bh = make_float2(0.f, 0.f), bg = bh;
      if (col < inner) {  // inner % 8 == 0: col + 1 is in range too
        bh = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + col));
        bg = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bias + inner + col));
      }
#pragma unroll
      for (int r = 0; r < MH; ++r)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float* h = &acc[r][4 * i + 2 * hr];
          const float* gv = &acc[r][4 * (i + BN / 8) + 2 * hr];
          const int row = 64 * r + 16 * warp + g + 8 * hr;  // row % 8 == g
          *reinterpret_cast<uint32_t*>(staging + row * 128 +
                                       ((i ^ g) << 4) + t4 * 4) =
              pack_bf16x2((h[0] + bh.x) * gate_fn<GATE, true>(gv[0] + bg.x),
                          (h[1] + bh.y) * gate_fn<GATE, true>(gv[1] + bg.y));
        }
    }
    fence_proxy_async();
    named_sync(epilogue_bar, 128);
    if (tid == 0) {
      tma_store_4d(&to, staging, n0, 0, m0, 0);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// ---------------------------------------------------------------- fp32

// The fp32 kernel's tiles. A block's tile is BM = 128 rows x BN = 64
// output columns, 64 rows a consumer warpgroup: per 8-deep K step three
// m64n128k8 TF32 products a warpgroup (x.lo W.hi, x.hi W.lo, x.hi W.hi)
// over W's BN h rows and BN gate rows side by side (h column j and gate
// column j in one thread's accumulators, as in the bf16 kernel). A stage
// is one KS = 32 wide K slice (one 128-byte swizzled panel of fp32): the
// x tile, split into hi and lo in registers as the A fragments are read,
// and W's hi and lo tiles, which geglu_split_w_kernel wrote before the
// call. Both consumer warpgroups read every stage (one W tile for 128
// rows), so the ring is released by the eight consumer warps.
struct F32Cfg {
  static constexpr int BM = 128, BN = 64, KS = 32;
  // K steps (8 values each) whose products a restart sums from zero: a
  // stage's 32 K values, twelve products (see the note at the top)
  static constexpr int RESTART = 4;
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr uint32_t X_BYTES = BM * KS * 4;          // 16 KB
  static constexpr uint32_t W_BYTES = 2 * 2 * BN * KS * 4;  // hi, lo: 32 KB
  static constexpr uint32_t STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int NST = 4;
  static constexpr size_t OFF_BAR = (size_t)NST * STAGE_BYTES;
  // barriers: full[NST], empty[NST]; + 1024 B to align
  static constexpr size_t SMEM = OFF_BAR + 16 * NST + 1024;
  // row tiles a raster group: the blocks in flight share GROUP row tiles
  // of x and a few column tiles of W (W's hi and lo, 105 MB at spatial
  // level 2, exceed the L2 cache; a group's share is ~11 MB)
  static constexpr int GROUP = 16;
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536,
                "registers");
  static_assert(STAGE_BYTES % 1024 == 0 && SMEM <= 232448,
                "stages start on 1024-byte boundaries and fit");
  static_assert(KS == 32 && 4 % RESTART == 0, "restarts inside a stage");
};

// The origin of output tile `tile` in the grouped raster: GROUP row tiles
// at a time, column tile after column tile, the rows fastest.
__device__ __forceinline__ void f32_tile_origin(int tile, int n_m, int n_n,
                                                int& m0, int& n0) {
  constexpr int G = F32Cfg::GROUP;
  const int group = tile / (G * n_n);
  const int first = group * G;
  const int rows = min(G, n_m - first);
  const int local = tile - group * G * n_n;
  m0 = (first + local % rows) * F32Cfg::BM;
  n0 = (local / rows) * F32Cfg::BN;
}

// W (2 inner, C) fp32 -> W.hi then W.lo, each (2 inner, C) TF32 values
// (hi = rna_tf32(w), lo = rna_tf32(w - hi)), every 8-wide K group
// permuted so that slot s < 4 holds column 2s and slot s + 4 column 2s +
// 1: the A fragment's k slots t and t + 4 are then x's columns 2t and 2t +
// 1, one float2 in shared memory. One thread an 8-wide group.
__global__ void __launch_bounds__(256)
    geglu_split_w_kernel(const float4* __restrict__ w,
                         float4* __restrict__ ws, long long groups) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const float4 a = w[2 * i], b = w[2 * i + 1];
  const float v[8] = {a.x, a.z, b.x, b.z, a.y, a.w, b.y, b.w};
  float hi[8], lo[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t h, l;
    split(v[j], h, l);
    hi[j] = __uint_as_float(h);
    lo[j] = __uint_as_float(l);
  }
  ws[2 * i] = make_float4(hi[0], hi[1], hi[2], hi[3]);
  ws[2 * i + 1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
  ws[2 * (groups + i)] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  ws[2 * (groups + i) + 1] = make_float4(lo[4], lo[5], lo[6], lo[7]);
}

template <int GATE>
__global__ void __launch_bounds__(384, 1)
    geglu_f32_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int m, int c, int inner) {
  using C = F32Cfg;
  constexpr int BN = C::BN, KS = C::KS, NST = C::NST;
  static_assert(C::THREADS == 384, "the launch bounds");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + NST;

  const int wg = threadIdx.x / 128;
  const int n_m = (m + C::BM - 1) / C::BM, n_n = (inner + BN - 1) / BN;
  const int n_tiles = n_m * n_n;  // fits: checked on the host
  const int kt_n = (c + KS - 1) / KS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // the eight consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // --------------------------------------------------------- producer
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // K slices this block has loaded, over all its tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int m0, n0;
        f32_tile_origin(tile, n_m, n_n, m0, n0);
        for (int k = 0; k < kt_n; ++k, ++it) {
          const int st = it % NST;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          unsigned char* s = smem + st * C::STAGE_BYTES;
          // the x tile (BM rows), then W's hi and lo tiles (h rows, gate
          // rows of each: one box of (KS, BN, 2, 2))
          mbar_arrive_tx(&full[st], C::STAGE_BYTES);
          tma_load_4d(s, &tx, &full[st], k * KS, 0, m0, 0);
          tma_load_4d(s + C::X_BYTES, &tw, &full[st], k * KS, n0, 0, 0);
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this thread's x rows in the tile: g and g + 8 of its warp's 16 in its
  // warpgroup's 64 (both at g modulo the swizzle's 8)
  const int xr = 64 * (wg - 1) + 16 * warp + g;
  const uint32_t ring = smem_u32(smem);

  // m64n128k8 accumulators, BN h columns then BN gate columns: `part` sums
  // one stage's products from zero in the tensor cores (whose sums
  // truncate), `total` adds the stages up in f32
  float total[BN], part[BN];  // m64n(2 BN): 2 BN * 64 / 128 a thread

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int m0, n0;
    f32_tile_origin(tile, n_m, n_n, m0, n0);
#pragma unroll
    for (int i = 0; i < BN; ++i) total[i] = 0.f;
    for (int k = 0; k < kt_n; ++k, ++it) {
      const int st = it % NST;
      mbar_wait(&full[st], (it / NST) & 1);
      const unsigned char* xs = smem + st * C::STAGE_BYTES;
      const uint32_t wa = ring + st * C::STAGE_BYTES + C::X_BYTES;
      // A fragments of the slice's four K steps: slot t4 (a[0], a[1]) and
      // slot t4 + 4 (a[2], a[3]) of K step kk are x's columns 8kk + 2t4
      // and 8kk + 2t4 + 1 (W.hi and W.lo carry the same permutation), one
      // float2 of a 128-byte swizzled row, split into hi and lo
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = xr + 8 * hr;
          const float2 v = *reinterpret_cast<const float2*>(
              xs + row * 128 + (((2 * kk + (t4 >> 1)) ^ g) << 4) +
              (t4 & 1) * 8);
          split(v.x, ahi[kk][hr], alo[kk][hr]);
          split(v.y, ahi[kk][2 + hr], alo[kk][2 + hr]);
        }
      // each restart's products from zero: its small ones (x.lo W.hi, x.hi
      // W.lo) first, its x.hi W.hi last, so that only those add into a
      // sum of the restart's full size (each product truncates at the
      // size of the sum it adds into)
      constexpr int R = C::RESTART;
#pragma unroll
      for (int r0 = 0; r0 < 4; r0 += R) {
        fence_regs<BN>(part);
        wgmma_fence();
#pragma unroll
        for (int kk = r0; kk < r0 + R; ++kk) {
          const uint64_t bhi = desc_kmajor(wa, 0, kk);
          const uint64_t blo = desc_kmajor(wa + 2 * BN * 128, 0, kk);
          wgmma_tf32_rs128(part, alo[kk], bhi, kk != r0);
          wgmma_tf32_rs128(part, ahi[kk], blo, 1);
        }
#pragma unroll
        for (int kk = r0; kk < r0 + R; ++kk)
          wgmma_tf32_rs128(part, ahi[kk], desc_kmajor(wa, 0, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BN>(part);
        if (r0 + R == 4) {
          // the stage is read (x into registers, W by the products)
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
        }
#pragma unroll
        for (int i = 0; i < BN; ++i) total[i] += part[i];
      }
    }

    // epilogue: bias and gate in f32 (IEEE division and exp2), out
    // written from registers: each row's 8 bytes at columns 2t4, 2t4 + 1
    // of every 8, full 32-byte sectors
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      if (col >= inner) continue;  // inner % 8 == 0: col + 1 is in range
      const float2 bh = *reinterpret_cast<const float2*>(bias + col);
      const float2 bg = *reinterpret_cast<const float2*>(bias + inner + col);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + xr + 8 * hr;
        if (row >= m) continue;
        const float* h = &total[4 * i + 2 * hr];
        const float* gv = &total[4 * (i + BN / 8) + 2 * hr];
        *reinterpret_cast<float2*>(out + (long long)row * inner + col) =
            make_float2((h[0] + bh.x) * gate_fn<GATE, false>(gv[0] + bg.x),
                        (h[1] + bh.y) * gate_fn<GATE, false>(gv[1] + bg.y));
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <int GATE>
int launch_bf16(const GegluCall& call, cudaStream_t stream) {
  using C = Bf16Cfg;
  constexpr int CL = C::CLUSTER;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  static std::atomic<uint64_t> smem_set{0};
  static std::atomic<int> clusters[64];
  const long long n_tiles =
      (long long)((call.m + CL * C::BM - 1) / (CL * C::BM)) *
      ((call.inner + C::BN - 1) / C::BN);
  if (n_tiles > 0x7fffffff) return -2;
  const long long c = call.c, inner = call.inner;
  const bf16* w = static_cast<const bf16*>(call.w);
  // (1, rows, 1, cols) views; boxes of 64 columns (one swizzled panel)
  CUtensorMap tx, th, tg, to;
  int e = cached_bshd_tensor_map(&tx, BF16, 2, call.x, 1, call.m, 1, call.c,
                                 c, c, c, 64, C::BM, SW);
  if (e == 0)
    e = cached_bshd_tensor_map(&th, BF16, 2, w, 1, call.inner, 1, call.c, c,
                               c, c, 64, C::BN, SW);
  if (e == 0)
    e = cached_bshd_tensor_map(&tg, BF16, 2, w + inner * c, 1, call.inner, 1,
                               call.c, c, c, c, 64, C::BN, SW);
  if (e == 0)
    e = cached_bshd_tensor_map(&to, BF16, 2, call.out, 1, call.m, 1,
                               call.inner, inner, inner, inner, 64, C::BM,
                               SW);
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  auto kern = geglu_bf16_kernel<GATE>;
  e = allow_smem_once(kern, (int)C::SMEM, call.device, smem_set);
  if (e != 0) return e;
  // as many clusters as fit on the card at once (one block an SM)
  const int fit = max_active_clusters(kern, CL, C::THREADS,
                                      (int)C::SMEM, call.device, clusters);
  if (fit < 1) return -2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * (n_tiles < fit ? (int)n_tiles : fit), 1, 1);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kern, tx, th, tg, to,
                              static_cast<const bf16*>(call.b), call.m,
                              call.c, call.inner);
  return e != 0 ? e : (int)cudaGetLastError();
}

template <int GATE>
int launch_f32(const GegluCall& call, cudaStream_t stream) {
  using C = F32Cfg;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  static std::atomic<uint64_t> smem_set{0};
  const long long n_tiles = (long long)((call.m + C::BM - 1) / C::BM) *
                            ((call.inner + C::BN - 1) / C::BN);
  if (n_tiles > 0x7fffffff || call.wsplit == nullptr) return -2;
  const long long c = call.c, inner = call.inner;
  // W.hi and W.lo into the caller's scratch (4 inner C floats)
  const long long groups = 2 * inner * c / 8;
  geglu_split_w_kernel<<<(unsigned)((groups + 255) / 256), 256, 0,
                         stream>>>(static_cast<const float4*>(call.w),
                                   static_cast<float4*>(call.wsplit),
                                   groups);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  // x as (1, M, 1, C), boxes of KS columns (one swizzled panel) by BM
  // rows; the split W as (C, inner, 2 [h, gate], 2 [hi, lo]), boxes of KS
  // columns by BN rows of both halves of both
  CUtensorMap tx, tw;
  e = cached_bshd_tensor_map(&tx, F32, 4, call.x, 1, call.m, 1, call.c, c,
                             c, c, C::KS, C::BM, SW);
  if (e == 0) {
    const long long dims[4] = {c, inner, 2, 2};
    const long long strides[3] = {c, inner * c, 2 * inner * c};
    const int box[4] = {C::KS, C::BN, 2, 2};
    e = cached_tensor_map_4d(&tw, F32, 4, call.wsplit, dims, strides, box,
                             SW);
  }
  if (e != 0) return e < 0 ? e : -1000 - e;  // a CUresult from the encode
  auto kern = geglu_f32_kernel<GATE>;
  e = allow_smem_once(kern, (int)C::SMEM, call.device, smem_set);
  if (e != 0) return e;
  const int sms = sm_count(call.device);
  if (sms < 1) return -2;
  const int grid = n_tiles < sms ? (int)n_tiles : sms;
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      tx, tw, static_cast<const float*>(call.b),
      static_cast<float*>(call.out), call.m, call.c, call.inner);
  return (int)cudaGetLastError();
}

template <int GATE>
int launch(const GegluCall& call) {
  cudaStream_t s = static_cast<cudaStream_t>(call.stream);
  if (call.m < 1 || call.device < 0 || call.device >= 64) return -2;
  if (call.dtype == kBFloat16) return launch_bf16<GATE>(call, s);
  if (call.dtype == kFloat32) return launch_f32<GATE>(call, s);
  return -1;
}

int geglu_fwd(const GegluCall& call) {
  switch (call.gate) {
    case kGateErf5: return launch<kGateErf5>(call);
    case kGateCdf3: return launch<kGateCdf3>(call);
    case kGatePoly14: return launch<kGatePoly14>(call);
    default: return -3;
  }
}

}  // namespace
}  // namespace vst

static_assert(offsetof(vst::GegluCall, gate) == 68 &&
                  sizeof(vst::GegluCall) == 72,
              "GegluCall must match ops/geglu.py's packing");

// One K2 call from its packed arguments: launched on the call's device,
// made current for the launch where another one is.
extern "C" int vst_geglu_fwd(const vst::GegluCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::geglu_fwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::geglu_fwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
