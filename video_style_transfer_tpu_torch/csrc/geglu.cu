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
// (C = 320..1280, M = 2048..524288): tensor-core bound in bf16, FMA
// bound in fp32. The fusion saves the (M, 2*inner) intermediate's write
// and re-read, which a separate matmul + gate would pay.
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
// fp32, `geglu_f32_kernel`: register-blocked FMA tiles (64 x 64 a block,
// 4x4 per thread for each half), exact division and exp2, so fp32 stays
// within 1e-5 of the plain version.

#include <cstddef>

#include "common.cuh"
#include "sm90.cuh"

namespace vst {

// The arguments of one K2 call as ops/geglu.py packs them (`_POINTERS`,
// `_LAYOUT`, `_GATE`: "<5Q", "<5i", "<i"): pointers and the stream, the
// device the call is for, then the scalars.
struct GegluCall {
  const void* x;
  const void* w;
  const void* b;
  void* out;
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
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int kThreadsF32 = 256;
constexpr int LDF = FM + 4;

struct GegluArgs {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  int m, c, inner;
};

template <int GATE>
__global__ void __launch_bounds__(kThreadsF32)
    geglu_f32_kernel(const GegluArgs a) {
  __shared__ __align__(16) float xs[FK][LDF];
  __shared__ __align__(16) float whs[FK][LDF];
  __shared__ __align__(16) float wgs[FK][LDF];
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int n0 = blockIdx.x * FN;
  const int m0 = blockIdx.y * FM;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float ah[4][4], ag[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ah[i][j] = ag[i][j] = 0.f;

  // one float4 of each tile per thread: row tid/4, k-vector tid%4
  const int lr = tid / 4, lk = (tid % 4) * 4;
  for (int k0 = 0; k0 < a.c; k0 += FK) {
    const int gk = k0 + lk;
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), hv = xv, gv = xv;
    if (m0 + lr < a.m && gk < a.c)
      xv = *reinterpret_cast<const float4*>(x + (long long)(m0 + lr) * a.c + gk);
    if (n0 + lr < a.inner && gk < a.c) {
      hv = *reinterpret_cast<const float4*>(w + (long long)(n0 + lr) * a.c + gk);
      gv = *reinterpret_cast<const float4*>(
          w + (long long)(n0 + lr + a.inner) * a.c + gk);
    }
    xs[lk + 0][lr] = xv.x; xs[lk + 1][lr] = xv.y;
    xs[lk + 2][lr] = xv.z; xs[lk + 3][lr] = xv.w;
    whs[lk + 0][lr] = hv.x; whs[lk + 1][lr] = hv.y;
    whs[lk + 2][lr] = hv.z; whs[lk + 3][lr] = hv.w;
    wgs[lk + 0][lr] = gv.x; wgs[lk + 1][lr] = gv.y;
    wgs[lk + 2][lr] = gv.z; wgs[lk + 3][lr] = gv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      const float4 bh = *reinterpret_cast<const float4*>(&whs[k][tx * 4]);
      const float4 bg = *reinterpret_cast<const float4*>(&wgs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float hr[4] = {bh.x, bh.y, bh.z, bh.w};
      const float gr[4] = {bg.x, bg.y, bg.z, bg.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[i][j] = fmaf(ar[i], hr[j], ah[i][j]);
          ag[i][j] = fmaf(ar[i], gr[j], ag[i][j]);
        }
    }
    __syncthreads();
  }
  const float* bias = static_cast<const float*>(a.b);
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= a.inner) continue;
      const float hvv = ah[i][j] + bias[gn];
      const float gvv = ag[i][j] + bias[gn + a.inner];
      out[(long long)gm * a.inner + gn] = hvv * gate_fn<GATE, false>(gvv);
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
int launch(const GegluCall& call) {
  cudaStream_t s = static_cast<cudaStream_t>(call.stream);
  if (call.m < 1 || call.device < 0 || call.device >= 64) return -2;
  if (call.dtype == kBFloat16) return launch_bf16<GATE>(call, s);
  if (call.dtype == kFloat32) {
    const GegluArgs a{call.x, call.w, call.b, call.out,
                      call.m, call.c, call.inner};
    dim3 grid((a.inner + FN - 1) / FN, (a.m + FM - 1) / FM);
    geglu_f32_kernel<GATE><<<grid, kThreadsF32, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
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

static_assert(offsetof(vst::GegluCall, gate) == 60 &&
                  sizeof(vst::GegluCall) == 64,
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
