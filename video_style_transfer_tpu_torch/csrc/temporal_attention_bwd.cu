// K5: per-pixel temporal (frame-axis) attention backward for Hopper, on
// the tensor cores.
//
// Replaces the JAX package's Pallas kernel ops/temporal_attention.py
// `_bwd_kernel` (launched by `_bwd_kernel_call`).
//
// For every pixel n and head h independently, over the F <= 32 frames:
// recompute w[f][g] = softmax_g(q_f . k_g * scale) (base 2, as K3), then
//   dp[f][g] = do_f . v_g,  delta_f = sum_g w[f][g] dp[f][g],
//   ds[f][g] = w[f][g] (dp[f][g] - delta_f) scale,
//   dq_f = sum_g ds[f][g] k_g,  dk_g = sum_f ds[f][g] q_f,
//   dv_g = sum_f w[f][g] do_f,
// all in f32, rounded once into the outputs. q, k, v are (F, N, H, d)
// strided views; dO is (F, N, H*d) contiguous; dq, dk, dv are written
// (F, N, H, d) contiguous.
//
// Bound on the H100: ~11 * F * d flops per (f, n, h) row (the JAX cost
// estimate) against 7 * d elements of traffic (q, k, v, dO in; dq, dk, dv
// out) is ~F flops per byte, far below the ridge: the kernel is bound by
// device-memory bandwidth. It reads each input element once and writes
// each output once.
//
// Design: a warp takes an "item", its five products on mma.sync, as K3's
// forward takes its two. An item is one (pixel, head) pair, or where F <=
// 8 as many pairs as one 16-row tile holds (two at the stage-2 clip's 8
// frames, eight at 2): their rows lie together in shared memory, so the
// item is one clip of up to 16 frames whose softmax is masked to each
// pair's own frames (w and ds are then zero between pairs, and the
// products need no other change).
// - S = Q K^T and dP = dO V^T (F x d . d x F) as K3's S (ta::scores: bf16
//   m16n8k16, fp32 at 3xTF32 with the sum over d taken 64 columns at a
//   time from zero and added in f32), one or two m16 row tiles.
// - The softmax and delta run on the accumulator rows (quad shuffles);
//   the normalised w and ds stay in the accumulators.
// - dQ = dS K takes dS's accumulator as its A fragment. dV = W^T dO and
//   dK = dS^T Q need the transposes: each 8 x 8 block moves across the
//   warp by movmatrix (fp32 values as their two 16-bit halves), so no F x
//   F matrix goes through shared memory. B (dO, K or Q) comes by
//   ldmatrix.trans (bf16) or by 32-bit loads in the permuted k order of
//   acc_to_a (fp32), as K3's V. fp32 products at 3xTF32; bf16 splits w and
//   ds into bf16 hi + lo and takes both products, so only the inputs'
//   own bf16 rounding reaches the sums (w or ds rounded to bf16 alone
//   would put ~3e-3 normwise on dV, dQ, dK, past the 2^-10 the card holds
//   them to). Output columns are made 32 at a time and written over rows
//   their inputs no longer need: dV over V (dead after dP), dQ over dO
//   (dead after dV), dK over K (dead after dQ), the warp synchronised
//   between the three.
// - Memory: persistent blocks, one an SM, as K3. A producer warp fills a
//   ring of stages on mbarriers, each stage the q, k, v and dO of Hb heads
//   x T pixels x all F frames, one TMA box per tensor through a 4-D (d, F,
//   H, N) tensor map of the strided view; before a slot takes its next
//   stage, the producer stores its dq, dk and dv by one TMA box each. The
//   box is LDP > d wide where that keeps the row pitch an odd number of
//   16-byte chunks (ldmatrix and the fp32 B loads then hit distinct banks).
//   Fifteen consumer warps (seven where F > 16) take a stage's items in
//   turn.
// - A head wider than a box (LDP > 256) is taken in column chunks of one
//   pair a stage ("chunked"): pass 0 sums S and dP over the pair's chunks
//   of q, k, v and dO, pass 1 loads q, k and dO again a chunk at a time
//   and makes that chunk of dq, dk and dv. Each pair keeps one warp for
//   all its stages (its S and dP stay in that warp's registers), and the
//   walk interleaves the chunks of a pair a consumer warp. So every pair
//   whose q, k and v fit a block (pair_fits in ops/temporal_attention.py,
//   K3's rule) is taken.
// The wrapper plans the stages (ops/temporal_attention.py: bwd_plan) and
// passes the plan in the call; the launcher checks that it fits. On an
// H100 the loads and stores alone take as long as the whole kernel at the
// stage-2 shapes (cli/profile_step.py --k5_cutouts): the products and
// softmax hide behind the data movement.
//
// VST_K5_CUTOUT (cli/profile_step.py --k5_cutouts) cuts the kernel: 1
// keeps the loads and stores alone (the outputs are not the gradients), 2
// has each block load and store its first tile again and again (its data
// stays in L2).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstring>

#include "common.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"
#include "temporal_attention.cuh"

#ifndef VST_K5_CUTOUT
#define VST_K5_CUTOUT 0
#endif

namespace vst {

// One K5 call's arguments (ops/temporal_attention.py packs them:
// _BWD_POINTERS, _LAYOUT, _BWD_PLAN, _SCALE)
struct TABwdCall {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  void* stream;
  long long q_sf, q_sn, q_sh;
  long long k_sf, k_sn, k_sh;
  long long v_sf, v_sn, v_sh;
  int device, dtype, frames, n, heads, head_dim;
  // the plan: shared row pitch, columns a stage holds of a row, column
  // chunks of a row (1: a stage holds whole pairs), heads and pixels a
  // stage, stages in the ring
  int ldp, cols, chunks, hb, tn, stages;
  float scale;
};

namespace {

using namespace sm90;
using namespace ta;

// Consumer warps a block, beside the producer warp: fifteen where an
// item's S is one row tile (F <= 16; 128 registers a thread), seven where
// it is two (255). Warps share an SM's four register files in turn, so
// nine warps would put three on one and cap a thread at 168 registers,
// where S, dP, w, ds and the output chunks of two row tiles spill. An
// item's work is a chain of dependent products and shuffles: more warps
// hide more of it (15 against 8 took L0 fp32 from 0.49 to 0.44 ms on an
// H100).
template <int NT>
__host__ __device__ constexpr int consumers() {
  return NT <= 2 ? 15 : 7;
}
constexpr int MAX_SMEM = 232448;               // a block's shared memory
constexpr int MAX_BOX = 256;  // elements a TMA box dimension
constexpr int OCOLS = 4;      // n tiles of an output made at a time

struct BwdArgs {
  long long tiles;  // stages in the grid's walk (chunked: groups of pairs)
  int consumers;    // consumer warps
  int pack;         // pairs an item (one row tile) takes
  int frames, n, heads, d;
  int ldp, cols, chunks, hb, tn;
  int h_tiles;      // stages across the heads
  int stages;       // the ring
  int region;       // bytes of one tensor's part of a stage
  int stage_bytes;
  int box_bytes;    // bytes of one tensor's box
  float scale, sl2;  // scale, scale * log2(e)
};

// What stage s of a block holds: the box origin (h0, n0, column c0), the
// pass (0: S and dP; 1: the gradients; 2: both, a stage of whole pairs),
// and in the chunked walk its pair's warp and whether that pair exists.
struct Stage {
  int h0, c0, pass, owner;
  long long n0;
  bool valid;
};

// The chunked walk: the block's groups of a pair a consumer warp in turn,
// each group's 2 * chunks steps in turn, each step's pairs in turn
__device__ __forceinline__ long long group_stages(const BwdArgs& a) {
  return 2LL * a.chunks * a.consumers;
}

__device__ __forceinline__ bool in_walk(const BwdArgs& a, long long s) {
  const long long unit = a.chunks == 1 ? s : s / group_stages(a);
  return blockIdx.x + unit * gridDim.x < a.tiles;
}

__device__ __forceinline__ Stage stage_of(const BwdArgs& a, long long s) {
  Stage t;
  if (a.chunks == 1) {
    const long long io =
        VST_K5_CUTOUT == 2 ? blockIdx.x : blockIdx.x + s * gridDim.x;
    t.h0 = (int)(io % a.h_tiles) * a.hb;
    t.n0 = (io / a.h_tiles) * a.tn;
    t.c0 = 0, t.pass = 2, t.owner = -1, t.valid = true;
  } else {
    const long long per = group_stages(a);
    const long long group = VST_K5_CUTOUT == 2
                                ? blockIdx.x
                                : blockIdx.x + (s / per) * gridDim.x;
    const int r = (int)(s % per), step = r / a.consumers;
    t.owner = r % a.consumers;
    const long long pair = group * a.consumers + t.owner;
    t.valid = pair < (long long)a.n * a.heads;
    t.h0 = (int)(pair % a.heads);
    t.n0 = pair / a.heads;
    t.pass = step / a.chunks;
    t.c0 = (step % a.chunks) * a.cols;
  }
  return t;
}

// ----------------------------------------------------------- F x F parts

// An F x F matrix in m16n8 accumulator layout, one or two row tiles of NT
// n tiles: x[mt][j][e] is row 16 mt + g + 8 (e / 2), column 8 j + 2 t +
// e % 2 (g = lane / 4, t = lane % 4).
template <int NT>
using Acc = float[(NT + 1) / 2][NT][4];

// S = Q K^T and dP = dO V^T added over `cols` columns of one pair (rows
// row_bytes apart at the shared addresses qb, kb, vb, ob)
template <typename T, int NT>
__device__ __forceinline__ void add_scores(Acc<NT>& s, Acc<NT>& dp,
                                           uint32_t qb, uint32_t kb,
                                           uint32_t vb, uint32_t ob,
                                           int frames, int cols,
                                           int row_bytes, uint32_t zero,
                                           int lane) {
  constexpr int MT = (NT + 1) / 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float x[NT][4];
    scores<T, NT>(x, qb, kb, mt, frames, cols, row_bytes, zero, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] += x[j][e];
    scores<T, NT>(x, ob, vb, mt, frames, cols, row_bytes, zero, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[mt][j][e] += x[j][e];
  }
}

template <int NT>
__device__ __forceinline__ void clear(Acc<NT>& x) {
#pragma unroll
  for (int mt = 0; mt < (NT + 1) / 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mt][j][e] = 0.f;
}

// Which of this lane's accumulator columns lie in its rows' own pair,
// where an item packs pairs of `pf` frames into one row tile: bit 2j + c
// of same[mt][r] for column 8j + 2t + c of row 16 mt + g + 8r
template <int NT>
__device__ __forceinline__ void pair_mask(uint32_t (&same)[(NT + 1) / 2][2],
                                          int pf, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < (NT + 1) / 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rp = (16 * mt + g + 8 * r) / pf;
      same[mt][r] = 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if ((8 * j + 2 * t + c) / pf == rp) same[mt][r] |= 1u << (2 * j + c);
    }
}

// S -> w = softmax over the frames g < F of each row's own pair (rows
// past the item's `frames`: 0), dP -> ds = w (dp - delta) scale, in place
template <int NT>
__device__ __forceinline__ void softmax_grad(
    Acc<NT>& s, Acc<NT>& dp, const uint32_t (&same)[(NT + 1) / 2][2],
    int frames, float sl2, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < (NT + 1) / 2; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f},
          delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * j + (e & 1);
        const float x = 8 * j + 2 * t + (e & 1) < frames &&
                                (same[mt][e >> 1] >> c & 1u)
                            ? s[mt][j][e] * sl2
                            : -INFINITY;
        s[mt][j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row past the item's frames may have every column masked: its
      // w is then 0, not exp2(-inf + inf)
      if (mx[r] == -INFINITY) mx[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][j][e] = exp2f(s[mt][j][e] - mx[e >> 1]);
        sum[e >> 1] += s[mt][j][e];
      }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = mt * 16 + g + 8 * r < frames ? 1.f / sum[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][j][e] *= inv[e >> 1];
        delta[e >> 1] = fmaf(s[mt][j][e], dp[mt][j][e], delta[e >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[mt][j][e] = s[mt][j][e] * (dp[mt][j][e] - delta[e >> 1]) * scale;
  }
}

// The 8 x 8 block (R, C) of an F x F accumulator (rows 8 R.., columns
// 8 C..): this lane's two values, row g, columns 2t, 2t + 1
template <int NT>
__device__ __forceinline__ float2 block(const Acc<NT>& x, int R, int C) {
  return make_float2(x[R / 2][C][2 * (R % 2)], x[R / 2][C][2 * (R % 2) + 1]);
}

// Block (R, C) of x's transpose: block (C, R) of x moved across the warp
// by movmatrix, its 32-bit values as their two 16-bit halves (zero for a
// block past the F x F matrix's NT x NT blocks)
template <int NT>
__device__ __forceinline__ float2 block_t(const Acc<NT>& x, int R, int C) {
  if (R >= NT) return make_float2(0.f, 0.f);
  const float2 b = block<NT>(x, C, R);
  const uint32_t u = __float_as_uint(b.x), w = __float_as_uint(b.y);
  const uint32_t hi = movmatrix_trans(__byte_perm(u, w, 0x7632));
  const uint32_t lo = movmatrix_trans(__byte_perm(u, w, 0x5410));
  return make_float2(__uint_as_float(__byte_perm(lo, hi, 0x5410)),
                     __uint_as_float(__byte_perm(lo, hi, 0x7632)));
}

// bf16 A fragments of an F x F matrix x (TRANS: of its transpose), its
// values split into bf16 hi + lo: [mt][kk] m16n8k16 for the k16 steps
// over the frames, [mt][NT / 2] the m16n8k8 tail (a[0], a[1]) where NT is
// odd
template <int NT>
struct Bf16Frags {
  uint32_t hi[(NT + 1) / 2][NT / 2 + 1][4], lo[(NT + 1) / 2][NT / 2 + 1][4];
};

template <int NT, bool TRANS>
__device__ __forceinline__ void bf16_frags(Bf16Frags<NT>& f,
                                           const Acc<NT>& x) {
#pragma unroll
  for (int mt = 0; mt < (NT + 1) / 2; ++mt)
#pragma unroll
    for (int kk = 0; kk <= NT / 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a[i]: rows 16 mt + 8 (i % 2), k columns 16 kk + 8 (i / 2)
        const int R = 2 * mt + i % 2, C = 2 * kk + i / 2;
        if (C >= NT) {
          f.hi[mt][kk][i] = f.lo[mt][kk][i] = 0u;
          continue;
        }
        const float2 v = TRANS ? block_t<NT>(x, R, C) : block<NT>(x, R, C);
        const uint32_t h = pack_bf16x2(v.x, v.y);
        const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&h);
        const float2 hf = __bfloat1622float2(hb);
        f.hi[mt][kk][i] = h;
        f.lo[mt][kk][i] = pack_bf16x2(v.x - hf.x, v.y - hf.y);
      }
}

// fp32 A fragments (3xTF32, k order permuted as acc_to_a) of x (TRANS:
// of its transpose): [mt][j] the m16n8k8 step over frames 8j..
template <int NT, bool TRANS>
__device__ __forceinline__ void f32_frags(FragA (&f)[(NT + 1) / 2][NT],
                                          const Acc<NT>& x) {
#pragma unroll
  for (int mt = 0; mt < (NT + 1) / 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 a = TRANS ? block_t<NT>(x, 2 * mt, j)
                             : block<NT>(x, 2 * mt, j);
      const float2 b = TRANS ? block_t<NT>(x, 2 * mt + 1, j)
                             : block<NT>(x, 2 * mt + 1, j);
      const float c[4] = {a.x, a.y, b.x, b.y};
      acc_to_a(f[mt][j], c);
    }
}

// --------------------------------------------------------- F x d products

// out (rows ldp apart, rows < F) = X B over the frames, X the F x F
// matrix x (TRANS: its transpose), B the F rows of one pair's tensor at
// shared address bb (pointer bs), over `cols` columns: OCOLS n tiles at a
// time. bf16 takes X's hi and lo parts on m16n8k16 (an m16n8k8 tail
// where NT is odd) against B by ldmatrix.trans; fp32 3xTF32 against B by
// 32-bit loads in acc_to_a's k order.
template <typename T, int NT, bool TRANS>
__device__ __forceinline__ void product(const Acc<NT>& x, uint32_t bb,
                                        const T* bs, T* out, int frames,
                                        int cols, int ldp, uint32_t zero,
                                        int lane) {
  constexpr int MT = (NT + 1) / 2;
  const int g = lane >> 2, t = lane & 3;
  const int nd = cols / 8;  // n tiles
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int K16 = NT / 2;
    Bf16Frags<NT> f;
    bf16_frags<NT, TRANS>(f, x);
    const int row_bytes = ldp * 2;
    // x4.trans lanes: B rows 16 kk + 8 * bit 3 + (lane & 7), columns 8 *
    // (n + bit 4); the k8 tail: rows 16 K16 + (lane & 7), columns 8 * (n
    // + lane / 8)
    const int vrow = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vcol = lane >> 4;
    for (int n0 = 0; n0 < nd; n0 += OCOLS) {
      float acc[MT][OCOLS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < OCOLS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K16; ++kk) {
        const int row = 16 * kk + vrow;
#pragma unroll
        for (int i = 0; i < OCOLS; i += 2) {
          const int col = 8 * (n0 + i + vcol);
          uint32_t b[4];
          ldmatrix_x4_trans(b, row < frames && col < cols
                                   ? bb + row * row_bytes + col * 2
                                   : zero);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(acc[mt][i], f.hi[mt][kk], {b[0], b[1]});
            mma_16816(acc[mt][i], f.lo[mt][kk], {b[0], b[1]});
            mma_16816(acc[mt][i + 1], f.hi[mt][kk], {b[2], b[3]});
            mma_16816(acc[mt][i + 1], f.lo[mt][kk], {b[2], b[3]});
          }
        }
      }
      if constexpr (NT % 2 == 1) {
        const int row = 16 * K16 + (lane & 7);
        const int col = 8 * (n0 + (lane >> 3));
        uint32_t b[4];
        ldmatrix_x4_trans(b, row < frames && col < cols
                                 ? bb + row * row_bytes + col * 2
                                 : zero);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < OCOLS; ++i) {
            mma_1688(acc[mt][i], f.hi[mt][K16][0], f.hi[mt][K16][1], b[i]);
            mma_1688(acc[mt][i], f.lo[mt][K16][0], f.lo[mt][K16][1], b[i]);
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mt + g + 8 * r;
          if (row >= frames) continue;
          T* o = out + row * ldp + 2 * t;
#pragma unroll
          for (int i = 0; i < OCOLS; ++i)
            if (n0 + i < nd)
              store2<T>(o + 8 * (n0 + i), acc[mt][i][2 * r],
                        acc[mt][i][2 * r + 1]);
        }
    }
  } else {
    (void)bb;
    FragA f[MT][NT];
    f32_frags<NT, TRANS>(f, x);
    for (int n0 = 0; n0 < nd; n0 += OCOLS) {
      float acc[MT][OCOLS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < OCOLS; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B rows in acc_to_a's k order: slot t = frame 8j + 2t, slot t + 4
        // = frame 8j + 2t + 1
        const int f0 = 8 * j + 2 * t;
        const T* b0 = bs + f0 * ldp + g;
#pragma unroll
        for (int i = 0; i < OCOLS; ++i) {
          const int col = 8 * (n0 + i);
          if (col < cols) {
            FragB fb;
            split(f0 < frames ? b0[col] : 0.f, fb.hi[0], fb.lo[0]);
            split(f0 + 1 < frames ? b0[ldp + col] : 0.f, fb.hi[1],
                  fb.lo[1]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3<false>(acc[mt][i], f[mt][j], fb);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * mt + g + 8 * r;
          if (row >= frames) continue;
          T* o = out + row * ldp + 2 * t;
#pragma unroll
          for (int i = 0; i < OCOLS; ++i)
            if (n0 + i < nd)
              store2<T>(o + 8 * (n0 + i), acc[mt][i][2 * r],
                        acc[mt][i][2 * r + 1]);
        }
    }
  }
}

// One pair's dq, dk and dv over `cols` columns from its w and ds, the
// pair's q, k, v, dO blocks at q, q + region, ..., q + 3 region (bytes):
// dV = W^T dO over V's rows, dQ = dS K over dO's rows, dK = dS^T Q over
// K's rows
template <typename T, int NT>
__device__ __forceinline__ void gradients(const Acc<NT>& w,
                                          const Acc<NT>& ds,
                                          unsigned char* q, int region,
                                          int frames, int cols, int ldp,
                                          uint32_t zero, int lane) {
  T* qs = reinterpret_cast<T*>(q);
  T* ks = reinterpret_cast<T*>(q + region);
  T* vs = reinterpret_cast<T*>(q + 2 * region);
  T* os = reinterpret_cast<T*>(q + 3 * region);
  product<T, NT, true>(w, smem_u32(os), os, vs, frames, cols, ldp, zero,
                       lane);
  __syncwarp();  // dO read by every lane before dQ takes its rows
  product<T, NT, false>(ds, smem_u32(ks), ks, os, frames, cols, ldp, zero,
                        lane);
  __syncwarp();  // K read before dK takes its rows
  product<T, NT, true>(ds, smem_u32(qs), qs, ks, frames, cols, ldp, zero,
                       lane);
}

// One item's part of stage `t` (`frames` rows: a pair, or the pairs packed
// into one row tile; their q, k, v, dO blocks at q, q + region, ...): pass
// 0 adds its columns to S and dP (from zero at the first chunk), pass 1
// makes w and ds (at the first chunk) and its columns of dq, dk and dv; a
// stage of whole pairs takes both
template <typename T, int NT>
__device__ __forceinline__ void item(
    Acc<NT>& sw, Acc<NT>& dpds, const uint32_t (&same)[(NT + 1) / 2][2],
    unsigned char* q, int frames, const BwdArgs& a, const Stage& t,
    int row_bytes, uint32_t zero, int lane) {
#if VST_K5_CUTOUT != 1
  if (t.pass != 1) {
    const uint32_t qb = smem_u32(q);
    if (t.c0 == 0) {
      clear<NT>(sw);
      clear<NT>(dpds);
    }
    add_scores<T, NT>(sw, dpds, qb, qb + a.region, qb + 2 * a.region,
                      qb + 3 * a.region, frames, a.cols, row_bytes, zero,
                      lane);
  }
  if (t.pass != 0) {
    if (t.c0 == 0)
      softmax_grad<NT>(sw, dpds, same, frames, a.sl2, a.scale, lane);
    gradients<T, NT>(sw, dpds, q, a.region, frames, a.cols, a.ldp, zero,
                     lane);
  }
#endif
}

// The outputs of stage slot `st` holding `t` (dq over dO, dk over K, dv
// over V), one TMA store each; returns once the copies have read the
// stage. Lane 0 of the producer warp calls it.
__device__ __forceinline__ void store_stage(const BwdArgs& a,
                                            const CUtensorMap* tdq,
                                            const CUtensorMap* tdk,
                                            const CUtensorMap* tdv,
                                            const unsigned char* st,
                                            const Stage& t) {
  if (!t.valid || t.pass == 0) return;
  tma_store_4d(tdq, st + 3 * a.region, t.c0, 0, t.h0, (int)t.n0);
  tma_store_4d(tdk, st + a.region, t.c0, 0, t.h0, (int)t.n0);
  tma_store_4d(tdv, st + 2 * a.region, t.c0, 0, t.h0, (int)t.n0);
  bulk_commit();
  bulk_wait_read();
}

template <typename T, int NT>
__global__ void __launch_bounds__(32 * (consumers<NT>() + 1), 1)
    ta_bwd_mma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tdq,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv,
                      const BwdArgs a) {
  constexpr int CONSUMERS = consumers<NT>();
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + a.stages *
                                               a.stage_bytes);
  uint64_t* empty = full + a.stages;
  uint4* zero_row = reinterpret_cast<uint4*>(empty + a.stages);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool chunked = a.chunks > 1;
  // a stage's items: its pairs in groups of `pack` (chunked: one pair)
  const int items = (a.hb * a.tn + a.pack - 1) / a.pack;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, chunked ? 1 : items);
    }
    *zero_row = make_uint4(0u, 0u, 0u, 0u);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: before a slot takes its next stage, the stage it held
    // has been consumed and its outputs stored
    if (lane == 0) {
      long long s = 0;
      for (; in_walk(a, s); ++s) {
        const int slot = (int)(s % a.stages);
        unsigned char* st = smem + (size_t)slot * a.stage_bytes;
        if (s >= a.stages) {
          const long long r = s - a.stages;
          mbar_wait(empty + slot, (r / a.stages) & 1);
          store_stage(a, &tdq, &tdk, &tdv, st, stage_of(a, r));
        }
        const Stage t = stage_of(a, s);
        const int n0 = (int)t.n0;
        if (!t.valid) {
          mbar_arrive(full + slot);
          continue;
        }
        mbar_arrive_tx(full + slot, (t.pass == 1 ? 3 : 4) * a.box_bytes);
        tma_load_4d(st, &tq, full + slot, t.c0, 0, t.h0, n0);
        tma_load_4d(st + a.region, &tk, full + slot, t.c0, 0, t.h0, n0);
        if (t.pass != 1)
          tma_load_4d(st + 2 * a.region, &tv, full + slot, t.c0, 0, t.h0,
                      n0);
        tma_load_4d(st + 3 * a.region, &tdo, full + slot, t.c0, 0, t.h0,
                    n0);
      }
      // the last stages' outputs
      for (long long r = s > a.stages ? s - a.stages : 0; r < s; ++r) {
        const int slot = (int)(r % a.stages);
        mbar_wait(empty + slot, (r / a.stages) & 1);
        store_stage(a, &tdq, &tdk, &tdv,
                    smem + (size_t)slot * a.stage_bytes, stage_of(a, r));
      }
      bulk_wait();
    }
    return;
  }

  // a consumer. Stages of whole pairs: item i of stage s (its pairs i *
  // pack.., [pixel][head] in the stage) is the block's item s * items + i,
  // taken by warp (s * items + i) % CONSUMERS. Chunked: a stage's one pair is
  // its owner warp's in all its stages. Every warp waits on every stage in
  // turn, those without an item of it too: a wait on a stage's parity is
  // then never a full ring ahead of the phase the barrier is in.
  const uint32_t zero = smem_u32(zero_row);
  const int row_bytes = a.ldp * (int)sizeof(T);
  const size_t pair_bytes = (size_t)a.frames * a.ldp * sizeof(T);
  const int pairs = a.hb * a.tn;  // a stage's
  uint32_t same[(NT + 1) / 2][2];
  pair_mask<NT>(same, a.frames, lane);
  Acc<NT> sw, dpds;  // S then w, dP then ds: kept across a chunked pair
  clear<NT>(sw);
  clear<NT>(dpds);
  for (long long s = 0; in_walk(a, s); ++s) {
    const int slot = (int)(s % a.stages);
    mbar_wait(full + slot, (s / a.stages) & 1);
    unsigned char* st = smem + (size_t)slot * a.stage_bytes;
    const Stage t = stage_of(a, s);
    const int first =
        chunked ? (t.owner == warp ? 0 : items)
                : (int)((warp + CONSUMERS - (s * items) % CONSUMERS) %
                        CONSUMERS);
    for (int i = first; i < items; i += CONSUMERS) {
      // item i: pairs [p0, p0 + np) of the stage, [pixel][head]
      const int p0 = i * a.pack, np = min(a.pack, pairs - p0);
      const int tp = p0 / a.hb, hp = p0 - tp * a.hb;
      if (t.valid && t.h0 + hp < a.heads && t.n0 + tp < a.n)
        item<T, NT>(sw, dpds, same, st + p0 * pair_bytes, np * a.frames, a,
                    t, row_bytes, zero, lane);
      fence_proxy_async();  // the outputs, for the producer's stores
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }
}

// Pairs an item takes: as many pairs of F <= 8 frames as one 16-row tile
// holds (a stage of whole pairs), else one
int pack(const TABwdCall& c) {
  return c.chunks == 1 && c.frames <= 8 ? 16 / c.frames : 1;
}

template <typename T, int NT>
int launch(const TABwdCall& c, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  static std::atomic<uint64_t> smem_set{0};
  const int F = c.frames, d = c.head_dim, H = c.heads, N = c.n;
  BwdArgs a{};
  a.frames = F, a.n = N, a.heads = H, a.d = d;
  a.ldp = c.ldp, a.cols = c.cols, a.chunks = c.chunks, a.hb = c.hb,
  a.tn = c.tn, a.stages = c.stages;
  a.scale = c.scale, a.sl2 = c.scale * kLog2e;
  constexpr int CONSUMERS = consumers<NT>();
  a.consumers = CONSUMERS;
  const bool chunked = c.chunks > 1;
  a.pack = pack(c);
  // the plan: boxes of at most MAX_BOX, rows of whole 16-byte chunks, a
  // stage of whole pairs covering d, a chunked one one pair a stage
  if (c.ldp < 8 || c.ldp > MAX_BOX || c.ldp * es % 16 || c.cols < 8 ||
      c.cols % 8 || c.cols > c.ldp || c.hb < 1 || c.hb > MAX_BOX ||
      c.tn < 1 || c.tn > MAX_BOX || c.stages < 1 ||
      (chunked ? c.hb != 1 || c.tn != 1 || c.cols != c.ldp ||
                     (long long)c.chunks * c.cols < d
               : c.chunks != 1 || c.cols != d))
    return -2;
  a.box_bytes = a.hb * a.tn * F * a.ldp * es;
  a.region = (int)align128((size_t)a.box_bytes);
  a.stage_bytes = 4 * a.region;
  const long long smem = (long long)a.stages * (a.stage_bytes + 16) + 16;
  if (smem > MAX_SMEM) return -4;
  a.h_tiles = (H + a.hb - 1) / a.hb;
  a.tiles = chunked ? ((long long)N * H + CONSUMERS - 1) / CONSUMERS
                    : (long long)a.h_tiles * ((N + a.tn - 1) / a.tn);

  constexpr CUtensorMapDataType TY = std::is_same<T, bf16>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // (d, F, H, N) views: each pair's F rows land together
  const long long dims[4] = {d, F, H, N};
  const int box[4] = {a.ldp, F, a.hb, a.tn};
  const long long sq[3] = {c.q_sf, c.q_sh, c.q_sn};
  const long long sk[3] = {c.k_sf, c.k_sh, c.k_sn};
  const long long sv[3] = {c.v_sf, c.v_sh, c.v_sn};
  // dO and the outputs: (F, N, H*d) contiguous, the same (d, F, H, N) view
  const long long so[3] = {(long long)N * H * d, d, (long long)H * d};
  CUtensorMap tq, tk, tv, tdo, tdq, tdk, tdv;
  const void* srcs[7] = {c.q, c.k, c.v, c.dout, c.dq, c.dk, c.dv};
  const long long* strides[7] = {sq, sk, sv, so, so, so, so};
  CUtensorMap* maps[7] = {&tq, &tk, &tv, &tdo, &tdq, &tdk, &tdv};
  for (int i = 0; i < 7; ++i) {
    std::memset(maps[i], 0, sizeof(CUtensorMap));
    const long long st[3] = {strides[i][0], strides[i][1], strides[i][2]};
    const int e = cached_tensor_map_4d(maps[i], TY, es, srcs[i], dims, st,
                                       box);
    if (e != 0) return e;
  }
  auto kern = ta_bwd_mma_kernel<T, NT>;
  const int e = allow_smem_once(kern, MAX_SMEM, c.device, smem_set);
  if (e != 0) return e;
  const int sms = sm_count(c.device);
  if (sms == 0) return -5;
  const long long grid = std::min<long long>(a.tiles, sms);
  kern<<<(unsigned)grid, 32 * (CONSUMERS + 1), (int)smem, stream>>>(
      tq, tk, tv, tdo, tdq, tdk, tdv, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const TABwdCall& c, cudaStream_t s) {
  // NT: n tiles of an item's S, 8 frames each (two at least: the row
  // tile's 16)
  switch (std::max(2, (pack(c) * c.frames + 7) / 8)) {
    case 2: return launch<T, 2>(c, s);
    case 3: return launch<T, 3>(c, s);
    case 4: return launch<T, 4>(c, s);
    default: return -2;
  }
}

int ta_bwd(const TABwdCall& c) {
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  if (c.frames < 1 || c.n < 1 || c.heads < 1 || c.head_dim < 8 ||
      c.head_dim % 8 || c.device < 0 || c.device >= 64)
    return -2;
  for (long long st : {c.q_sf, c.q_sn, c.q_sh, c.k_sf, c.k_sn, c.k_sh,
                       c.v_sf, c.v_sn, c.v_sh})
    if (st <= 0) return -2;  // a TMA map takes no zero stride
  if (c.dtype == kFloat32) return dispatch<float>(c, s);
  if (c.dtype == kBFloat16) return dispatch<bf16>(c, s);
  return -1;
}

}  // namespace
}  // namespace vst

static_assert(offsetof(vst::TABwdCall, ldp) == 160 &&
                  offsetof(vst::TABwdCall, scale) == 184 &&
                  sizeof(vst::TABwdCall) == 192,
              "TABwdCall must match ops/temporal_attention.py's packing");

// One K5 call from its packed arguments: launched on the call's device,
// made current for the launch where another one is.
extern "C" int vst_temporal_attention_bwd(const vst::TABwdCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::ta_bwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::ta_bwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
