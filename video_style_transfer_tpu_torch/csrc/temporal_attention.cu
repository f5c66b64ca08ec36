// K3: per-pixel temporal (frame-axis) attention forward for Hopper, on the
// tensor cores.
//
// Replaces the JAX package's Pallas kernel ops/temporal_attention.py
// `_kernel` (launched by `_fwd_kernel_call`).
//
// For every pixel n and head h independently: logits[f][g] =
// q[f,n,h,:] . k[g,n,h,:] * scale over the F <= 32 frames, a base-2
// softmax over g, and o[f,n,h,:] = sum_g w[f][g] v[g,n,h,:], with f32
// logits and accumulation. q, k, v are (F, N, H, d) strided views (the
// motion module's fused (F, N, 3P) projection, read in place); the output
// is (F, N, H*d) contiguous.
//
// Bound on the H100: ~4*F*d flops per (f, n, h) output row against
// 4*d*bytes of q/k/v/o traffic is ~F/2 flops per byte at F = 16, far
// below the ridge: the kernel is bound by device-memory bandwidth. It
// reads each q/k/v element once and writes each output once.
//
// Design: a (pixel, head) pair's two products, S = Q K^T (F x d . d x F)
// and O = P V (F x F . F x d), are one or two m16 row tiles of mma.sync
// each, so a warp takes one row tile of one pair (an "item"):
// - bf16 on m16n8k16 (an m16n8k8 tail where d % 16 = 8); fp32 at 3xTF32 on
//   m16n8k8 TF32, each operand split into hi = rna_tf32(x) and lo =
//   rna_tf32(x - hi), three products a product (mma_sync.cuh, as K1's
//   fp32 d = 64 route), S's sum over d taken 64 columns at a time from
//   zero in the tensor core and added in f32 (tensor-core sums truncate).
// - Q and K fragments come by ldmatrix; V's by ldmatrix.trans (bf16) or
//   by 32-bit loads in the permuted k order that makes P's accumulator
//   its own A fragment (fp32). Frames past F read a 16-byte zero row and
//   are masked to -inf in S; rows past F are never stored.
// - The softmax runs on S's accumulator rows (quad shuffles); bf16 rounds
//   the unnormalised P to bf16 for P V and scales O by the f32 1/sum
//   afterwards. O is made 32 columns at a time (registers do not grow
//   with d) and written over the item's own rows of q in shared memory.
// - Memory: persistent blocks, one an SM. A producer warp fills a ring of
//   stages on mbarriers, each stage the q, k and v of Hb heads x T pixels
//   x all F frames, by one TMA box per tensor through a 4-D (d, F, H, N)
//   tensor map of the strided view, so each pair lands as a contiguous
//   F x LDP block; before a slot takes its next stage, the producer stores
//   the output the slot holds by one TMA box of the same shape. The box is
//   LDP > d wide where that keeps the row pitch an odd number of 16-byte
//   chunks (the columns past d are out of bounds: zero-filled on loads,
//   never read or written in memory), so ldmatrix and the fp32 V loads
//   are free of bank conflicts. A stage aims at 36 KB (L0 bf16: a pixel's
//   8 heads). Eight consumer warps take its items in turn and free it,
//   each warp waiting on every stage in order. A head wider than a box
//   (LDP > 256) takes one pair a stage, moved by 1-D bulk copies of its
//   rows.
// - Shared memory holds only the stages, their two barriers and the zero
//   row, so every pair whose q, k and v fit a block (pair_fits in
//   ops/temporal_attention.py) is taken, in the rows mode at one stage.
//
// VST_TA_CUTOUT (cli/profile_step.py --k3_cutouts) cuts the kernel: 1
// keeps the loads and stores alone (the output zeros), 2 has each block
// load and store its first tile again and again (its data stays in L2).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstring>

#include "common.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"
#include "temporal_attention.cuh"

#ifndef VST_TA_CUTOUT
#define VST_TA_CUTOUT 0
#endif

namespace vst {

// One K3 call's arguments (ops/temporal_attention.py packs them: _POINTERS,
// _LAYOUT, _SCALE)
struct TACall {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* stream;
  long long q_sf, q_sn, q_sh;
  long long k_sf, k_sn, k_sh;
  long long v_sf, v_sn, v_sh;
  int device, dtype, frames, n, heads, head_dim;
  float scale;
};

namespace {

using namespace sm90;
using namespace ta;

constexpr int CONSUMERS = 8;                   // consumer warps a block
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and the producer warp
constexpr int MAX_STAGES = 8;
constexpr int STAGE_TARGET = 36 * 1024;  // bytes a stage aims at
constexpr int MAX_SMEM = 232448;         // a block's shared memory
constexpr int MAX_BOX = 256;             // elements a TMA box dimension
constexpr int OCOLS = 4;                 // n tiles of O made at a time

struct TAArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sf, q_sn, q_sh;
  long long k_sf, k_sn, k_sh;
  long long v_sf, v_sn, v_sh;
  long long tiles;     // stages in the grid's walk
  int frames, n, heads, d;
  int ldp;             // elements a shared row
  int hb, tn;          // heads and pixels a stage
  int h_tiles;         // stages across the heads
  int rows_mode;       // stages filled by 1-D row copies
  int stages;          // the ring
  int region;          // bytes of one tensor's part of a stage
  int stage_bytes;
  int tx_bytes;        // bytes a stage's loads complete
  float sl2;           // scale * log2(e)
};

// One item: row tile mt of the pair whose q, k, v blocks start at qb, kb,
// vb (shared addresses; vs is vb's pointer), its O written over its own
// rows of q (`out`, the pair's q block; rows ldp apart), from where the
// stage's output leaves by one TMA store.
template <typename T, int NT>
__device__ void item(uint32_t qb, uint32_t kb, uint32_t vb, const T* vs,
                     T* out, int mt, int frames, int d, int ldp,
                     uint32_t zero, float sl2, int lane) {
  constexpr bool BF16 = std::is_same<T, bf16>::value;
  const int g = lane >> 2, t = lane & 3;
  const int row_bytes = ldp * (int)sizeof(T);
  const int r0 = mt * 16 + g;  // this lane's rows r0 and r0 + 8
  const int nd = d / 8;        // n tiles of O

#if VST_TA_CUTOUT == 1
  for (int r = 0; r < 2; ++r)
    if (r0 + 8 * r < frames)
      for (int n = 0; n < nd; ++n)
        store2<T>(out + (r0 + 8 * r) * ldp + 8 * n + 2 * t, 0.f, 0.f);
  return;
#endif

  float s[NT][4];
  scores<T, NT>(s, qb, kb, mt, frames, d, row_bytes, zero, lane);

  // softmax over the frames g < F of rows r0 and r0 + 8 (the quad of
  // lanes t = 0..3 holds a row)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = 8 * j + 2 * t + (e & 1) < frames ? s[j][e] * sl2
                                                       : -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    inv[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
      inv[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] += __shfl_xor_sync(0xffffffffu, inv[r], 1);
    inv[r] += __shfl_xor_sync(0xffffffffu, inv[r], 2);
    inv[r] = 1.f / inv[r];
  }

  // O = P V, OCOLS n tiles (8 columns each) at a time
  if constexpr (BF16) {
    constexpr int K16 = NT / 2;  // k16 steps over the frames, then a k8
    uint32_t pa[K16 + 1][4];
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    if constexpr (NT % 2 == 1) {
      pa[K16][0] = pack_bf16x2(s[NT - 1][0], s[NT - 1][1]);
      pa[K16][1] = pack_bf16x2(s[NT - 1][2], s[NT - 1][3]);
    }
    // x4.trans lanes: V rows 16 kk + 8 * bit 3 + (lane & 7), columns 8 *
    // (n + bit 4); the k8 tail: rows 16 K16 + (lane & 7), columns 8 * (n
    // + lane / 8)
    const int vrow = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vcol = lane >> 4;
    for (int n0 = 0; n0 < nd; n0 += OCOLS) {
      float acc[OCOLS][4];
#pragma unroll
      for (int i = 0; i < OCOLS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K16; ++kk) {
        const int row = 16 * kk + vrow;
#pragma unroll
        for (int i = 0; i < OCOLS; i += 2) {
          const int col = 8 * (n0 + i + vcol);
          uint32_t b[4];
          ldmatrix_x4_trans(b, row < frames && col < d
                                   ? vb + row * row_bytes + col * 2
                                   : zero);
          mma_16816(acc[i], pa[kk], {b[0], b[1]});
          mma_16816(acc[i + 1], pa[kk], {b[2], b[3]});
        }
      }
      if constexpr (NT % 2 == 1) {
        const int row = 16 * K16 + (lane & 7);
        const int col = 8 * (n0 + (lane >> 3));
        uint32_t b[4];
        ldmatrix_x4_trans(b, row < frames && col < d
                                 ? vb + row * row_bytes + col * 2
                                 : zero);
#pragma unroll
        for (int i = 0; i < OCOLS; ++i)
          mma_1688(acc[i], pa[K16][0], pa[K16][1], b[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + 8 * r >= frames) continue;
        T* o = out + (r0 + 8 * r) * ldp + 2 * t;
#pragma unroll
        for (int i = 0; i < OCOLS; ++i)
          if (n0 + i < nd)
            store2<T>(o + 8 * (n0 + i), acc[i][2 * r] * inv[r],
                      acc[i][2 * r + 1] * inv[r]);
      }
    }
  } else {
    FragA pa[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc_to_a(pa[j], s[j]);
    (void)vb;
    for (int n0 = 0; n0 < nd; n0 += OCOLS) {
      float acc[OCOLS][4];
#pragma unroll
      for (int i = 0; i < OCOLS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B rows in acc_to_a's k order: slot t = frame 8j + 2t, slot t + 4
        // = frame 8j + 2t + 1
        const int f0 = 8 * j + 2 * t;
        const T* v0 = vs + f0 * ldp + g;
#pragma unroll
        for (int i = 0; i < OCOLS; ++i) {
          const int col = 8 * (n0 + i);
          if (col < d) {
            FragB fb;
            split(f0 < frames ? v0[col] : 0.f, fb.hi[0], fb.lo[0]);
            split(f0 + 1 < frames ? v0[ldp + col] : 0.f, fb.hi[1],
                  fb.lo[1]);
            mma3<false>(acc[i], pa[j], fb);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r0 + 8 * r >= frames) continue;
        T* o = out + (r0 + 8 * r) * ldp + 2 * t;
#pragma unroll
        for (int i = 0; i < OCOLS; ++i)
          if (n0 + i < nd)
            store2<T>(o + 8 * (n0 + i), acc[i][2 * r] * inv[r],
                      acc[i][2 * r + 1] * inv[r]);
      }
    }
  }
}

// The output of stage slot `st` (O over its q rows) for the tile at (h0,
// n0): one TMA store through `to`, or a 1-D copy a row; returns once the
// copies have read the stage. The producer warp calls it.
template <typename T>
__device__ __forceinline__ void store_stage(const TAArgs& a,
                                            const CUtensorMap* to,
                                            const unsigned char* st, int h0,
                                            int n0, int lane) {
  if (!a.rows_mode) {
    if (lane == 0) tma_store_4d(to, st, 0, 0, h0, n0);
  } else {
    T* o = static_cast<T*>(a.o) + ((long long)n0 * a.heads + h0) * a.d;
    for (int f = lane; f < a.frames; f += 32)
      bulk_store(o + (long long)f * a.n * a.heads * a.d,
                 st + f * a.ldp * (int)sizeof(T), a.d * (int)sizeof(T));
  }
  bulk_commit();
  bulk_wait_read();
  __syncwarp();
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    ta_fwd_mma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      const TAArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages *
                                               a.stage_bytes);
  uint64_t* empty = full + a.stages;
  uint4* zero_row = reinterpret_cast<uint4*>(empty + a.stages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = a.hb * a.tn;
  const int mtiles = (a.frames + 15) / 16;
  const int items = pairs * mtiles;  // a stage's items
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, items);
    }
    *zero_row = make_uint4(0u, 0u, 0u, 0u);
    mbar_init_fence();
  }
  __syncthreads();
  // the tile a stage's loads and stores take (each block's first one,
  // again and again, in the resident cut)
  auto io_tile = [&](long long s) -> long long {
    return VST_TA_CUTOUT == 2 ? blockIdx.x : blockIdx.x + s * gridDim.x;
  };

  if (warp == CONSUMERS) {
    // the producer: stage s of this block holds tile blockIdx.x + s * grid.
    // Before a slot takes its next stage, the stage it held has been
    // consumed and its output stored.
    const T* src[3] = {static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                       static_cast<const T*>(a.v)};
    const long long sf[3] = {a.q_sf, a.k_sf, a.v_sf};
    const long long sn[3] = {a.q_sn, a.k_sn, a.v_sn};
    const long long sh[3] = {a.q_sh, a.k_sh, a.v_sh};
    long long s = 0;
    for (; blockIdx.x + s * gridDim.x < a.tiles; ++s) {
      const int slot = (int)(s % a.stages);
      unsigned char* st = smem + (size_t)slot * a.stage_bytes;
      if (s >= a.stages) {
        const long long r = s - a.stages, io = io_tile(r);
        mbar_wait(empty + slot, (r / a.stages) & 1);
        store_stage<T>(a, &to, st, (int)(io % a.h_tiles) * a.hb,
                       (int)(io / a.h_tiles) * a.tn, lane);
      }
      const long long io = io_tile(s);
      const int h0 = (int)(io % a.h_tiles) * a.hb;
      const int n0 = (int)(io / a.h_tiles) * a.tn;
      if (lane == 0) mbar_arrive_tx(full + slot, a.tx_bytes);
      __syncwarp();
      if (!a.rows_mode) {
        if (lane == 0) {
          tma_load_4d(st, &tq, full + slot, 0, 0, h0, n0);
          tma_load_4d(st + a.region, &tk, full + slot, 0, 0, h0, n0);
          tma_load_4d(st + 2 * a.region, &tv, full + slot, 0, 0, h0, n0);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 3; ++x)
          for (int f = lane; f < a.frames; f += 32)
            bulk_load(st + x * a.region + f * a.ldp * (int)sizeof(T),
                      src[x] + f * sf[x] + n0 * sn[x] + h0 * sh[x],
                      a.d * (int)sizeof(T), full + slot);
      }
    }
    // the last stages' outputs
    for (long long r = s > a.stages ? s - a.stages : 0; r < s; ++r) {
      const int slot = (int)(r % a.stages);
      const long long io = io_tile(r);
      mbar_wait(empty + slot, (r / a.stages) & 1);
      store_stage<T>(a, &to, smem + (size_t)slot * a.stage_bytes,
                     (int)(io % a.h_tiles) * a.hb,
                     (int)(io / a.h_tiles) * a.tn, lane);
    }
    bulk_wait();
    return;
  }

  // a consumer: item i of stage s (row tile i % mtiles of pair i / mtiles,
  // [pixel][head] in the stage) is the block's item s * items + i, taken
  // by warp (s * items + i) % CONSUMERS. Every warp waits on every stage
  // in turn, those without an item of it too: a wait on a stage's parity
  // is then never a full ring ahead of the phase the barrier is in.
  const uint32_t zero = smem_u32(zero_row);
  for (long long s = 0; blockIdx.x + s * gridDim.x < a.tiles; ++s) {
    const int slot = (int)(s % a.stages);
    mbar_wait(full + slot, (s / a.stages) & 1);
    const long long io = io_tile(s);
    unsigned char* st = smem + (size_t)slot * a.stage_bytes;
    for (int i = (int)((warp + CONSUMERS - (s * items) % CONSUMERS) %
                       CONSUMERS);
         i < items; i += CONSUMERS) {
      const int p = i / mtiles, mt = i - p * mtiles;
      const int tp = p / a.hb, hp = p - tp * a.hb;
      const int h = (int)(io % a.h_tiles) * a.hb + hp;
      const long long n = (io / a.h_tiles) * a.tn + tp;
      if (h < a.heads && n < a.n) {
        const size_t pair_off = (size_t)p * a.frames * a.ldp * sizeof(T);
        const uint32_t qb = smem_u32(st + pair_off);
        item<T, NT>(qb, qb + a.region, qb + 2 * a.region,
                    reinterpret_cast<const T*>(st + 2 * a.region + pair_off),
                    reinterpret_cast<T*>(st + pair_off), mt, a.frames, a.d,
                    a.ldp, zero, a.sl2, lane);
      }
      fence_proxy_async();  // O's rows, for the producer's store
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }
}

// LDP for d: d, or d plus one 16-byte chunk where d's chunks are even
// (an odd count puts the 8 rows of an ldmatrix on 8 distinct bank groups)
int padded(int d, int vec) { return (d / vec) % 2 == 0 ? d + vec : d; }

template <typename T, int NT>
int launch(const TACall& c, cudaStream_t stream) {
  constexpr int es = sizeof(T), vec = 16 / es;
  static std::atomic<uint64_t> smem_set{0};
  const int F = c.frames, d = c.head_dim, H = c.heads, N = c.n;
  TAArgs a{c.q,    c.k,    c.v,    c.o,    c.q_sf, c.q_sn, c.q_sh,
           c.k_sf, c.k_sn, c.k_sh, c.v_sf, c.v_sn, c.v_sh};
  a.frames = F, a.n = N, a.heads = H, a.d = d;
  a.sl2 = c.scale * kLog2e;
  // the last 32 bytes of a block: one stage's two barriers and the zero row
  auto stages_for = [](long long stage) {
    return (int)std::min<long long>(MAX_STAGES,
                                    (MAX_SMEM - 16) / (stage + 16));
  };
  const int ldp = padded(d, vec);
  // a TMA box takes strides of whole 16-byte chunks, none of them 0
  bool boxed = ldp <= MAX_BOX;
  for (long long st : {c.q_sf, c.q_sn, c.q_sh, c.k_sf, c.k_sn, c.k_sh,
                       c.v_sf, c.v_sn, c.v_sh})
    boxed = boxed && st > 0;
  if (boxed) {
    const long long pair = 3LL * F * ldp * es;
    int hb = 1;
    for (int x = std::min(H, MAX_BOX); x >= 1; --x)
      if (H % x == 0 && x * pair <= STAGE_TARGET) {
        hb = x;
        break;
      }
    const int tn = (int)std::max<long long>(
        1, std::min<long long>({STAGE_TARGET / (hb * pair), MAX_BOX, N}));
    a.ldp = ldp, a.hb = hb, a.tn = tn, a.rows_mode = 0;
    a.region = (int)align128((size_t)hb * tn * F * ldp * es);
    a.tx_bytes = 3 * hb * tn * F * ldp * es;
  } else {
    // one pair a stage, its rows padded where that still fits one stage
    const bool fits = 3LL * F * ldp * es + 32 <= MAX_SMEM;
    a.ldp = fits ? ldp : d, a.hb = 1, a.tn = 1, a.rows_mode = 1;
    a.region = F * a.ldp * es;
    a.tx_bytes = 3 * F * d * es;
  }
  a.stage_bytes = 3 * a.region;
  a.stages = stages_for(a.stage_bytes);
  if (a.stages < 1) return -4;
  a.h_tiles = (H + a.hb - 1) / a.hb;
  a.tiles = (long long)a.h_tiles * ((N + a.tn - 1) / a.tn);

  CUtensorMap tq, tk, tv, to;
  std::memset(&tq, 0, sizeof tq);
  std::memset(&tk, 0, sizeof tk);
  std::memset(&tv, 0, sizeof tv);
  std::memset(&to, 0, sizeof to);
  if (!a.rows_mode) {
    constexpr CUtensorMapDataType TY = std::is_same<T, bf16>::value
                                           ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    // (d, F, H, N) views: each pair's F rows land together
    const long long dims[4] = {d, F, H, N};
    const int box[4] = {a.ldp, F, a.hb, a.tn};
    const long long sq[3] = {c.q_sf, c.q_sh, c.q_sn};
    const long long sk[3] = {c.k_sf, c.k_sh, c.k_sn};
    const long long sv[3] = {c.v_sf, c.v_sh, c.v_sn};
    int e = cached_tensor_map_4d(&tq, TY, es, c.q, dims, sq, box);
    if (e == 0) e = cached_tensor_map_4d(&tk, TY, es, c.k, dims, sk, box);
    if (e == 0) e = cached_tensor_map_4d(&tv, TY, es, c.v, dims, sv, box);
    // the output (F, N, H*d) contiguous, as the same (d, F, H, N) view
    const long long so[3] = {(long long)N * H * d, d, (long long)H * d};
    if (e == 0) e = cached_tensor_map_4d(&to, TY, es, c.o, dims, so, box);
    if (e != 0) return e;
  }
  auto kern = ta_fwd_mma_kernel<T, NT>;
  const int smem = a.stages * (a.stage_bytes + 16) + 16;
  const int e = allow_smem_once(kern, MAX_SMEM, c.device, smem_set);
  if (e != 0) return e;
  const int sms = sm_count(c.device);
  if (sms == 0) return -5;
  const long long grid = std::min<long long>(a.tiles, sms);
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(tq, tk, tv, to, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const TACall& c, cudaStream_t s) {
  switch ((c.frames + 7) / 8) {
    case 1: return launch<T, 1>(c, s);
    case 2: return launch<T, 2>(c, s);
    case 3: return launch<T, 3>(c, s);
    case 4: return launch<T, 4>(c, s);
    default: return -2;
  }
}

int ta_fwd(const TACall& c) {
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  if (c.frames < 1 || c.n < 1 || c.heads < 1 || c.head_dim < 8 ||
      c.head_dim % 8 || c.device < 0 || c.device >= 64)
    return -2;
  if (c.dtype == kFloat32) return dispatch<float>(c, s);
  if (c.dtype == kBFloat16) return dispatch<bf16>(c, s);
  return -1;
}

}  // namespace
}  // namespace vst

static_assert(offsetof(vst::TACall, scale) == 136 &&
                  sizeof(vst::TACall) == 144,
              "TACall must match ops/temporal_attention.py's packing");

// One K3 call from its packed arguments: launched on the call's device,
// made current for the launch where another one is.
extern "C" int vst_temporal_attention_fwd(const vst::TACall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::ta_fwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::ta_fwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
