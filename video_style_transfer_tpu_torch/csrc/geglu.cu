// K2: fused GEGLU projection for Hopper.
//
// Replaces the JAX package's Pallas kernel ops/geglu.py `_make_kernel`
// (launched by `_fwd_call`).
//
// Computes out[m, j] = (x[m] . W[j] + b[j]) * gelu(x[m] . W[j + inner] +
// b[j + inner]) for x (M, C) and W (2*inner, C) (PyTorch's linear
// layout), reading the h rows [j] and the gate rows [j + inner] of W in
// place and writing only the gated (M, inner) half. The gate is chosen by
// the caller (erf5 / cdf3 / poly14, the JAX package's `_GATES`).
//
// Bound on the H100: 4*M*C*inner flops over (M*C + 2*C*inner + M*inner)
// elements of traffic is hundreds of flops per byte at the UNet shapes
// (C = 320..1280, M = 32768..524288): tensor-core bound in bf16, FMA
// bound in fp32. The fusion saves the (M, 2*inner) intermediate's write
// and re-read, which a separate matmul + gate would pay.
//
// Design: bf16 tiles of 128 rows x 128 output columns; each block
// computes BOTH the h tile and the gate tile from the same x tile (8
// warps of 64 x 32, mma.sync m16n8k16 with ldmatrix operands, f32
// accumulators in registers), streaming 64-deep K slices through a
// 3-stage cp.async pipeline. Rows past M, columns past inner and K past C
// are zero-filled (C, inner need only be multiples of 8). The h and gate
// accumulators of a tile share one fragment layout, so the epilogue adds
// the biases in f32, applies the gate and stores bf16 pairs straight
// from registers. fp32 takes a register-blocked FMA kernel (64 x 64
// tiles, 4x4 per thread for each half) so fp32 stays exact.

#include "common.cuh"

namespace vst {
namespace {

constexpr int kGateErf5 = 0;
constexpr int kGateCdf3 = 1;
constexpr int kGatePoly14 = 2;

// Abramowitz-Stegun 7.1.26 erf (the JAX package's `_erf_as`)
__device__ __forceinline__ float erf_as(float x) {
  const float sign = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = exp2f(-(ax * ax) * kLog2e);
  return sign * (1.f - poly * e);
}

__device__ __forceinline__ float gelu_erf5(float x) {
  return 0.5f * x * (1.f + erf_as(x * 0.70710678118654752f));
}

// direct 3-term normal CDF (Abramowitz-Stegun 26.2.16), `_gelu_cdf3`
__device__ __forceinline__ float gelu_cdf3(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.33267f * ax);
  const float poly = t * (0.4361836f + t * (-0.1201676f + t * 0.9372980f));
  const float pdf =
      0.3989422804014327f * exp2f(-(0.5f * kLog2e) * (ax * ax));
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

template <int GATE>
__device__ __forceinline__ float gate_fn(float g) {
  if constexpr (GATE == kGateErf5) return gelu_erf5(g);
  else if constexpr (GATE == kGateCdf3) return gelu_cdf3(g);
  else return gelu_poly14(g);
}

struct GegluArgs {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  int m, c, inner;
};

// ---------------------------------------------------------------- bf16
constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;
constexpr int kThreadsBf16 = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int LDS = BK + 8;        // bf16 per staged row (16 B pad)
constexpr size_t kXStage = sizeof(bf16) * BM * LDS;
constexpr size_t kWStage = sizeof(bf16) * BN * LDS;  // one W half
constexpr size_t kStage = kXStage + 2 * kWStage;
constexpr size_t kSmemBf16 = STAGES * kStage;

// x rows [m0, m0+BM) and W rows [n0, n0+BN) and [inner+n0, ...) of
// k-slice [k0, k0+BK) into one stage; out-of-range vectors zero-filled
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const GegluArgs& a, int m0,
                                           int n0, int k0) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  bf16* xs = reinterpret_cast<bf16*>(stage);
  bf16* whs = reinterpret_cast<bf16*>(stage + kXStage);
  bf16* wgs = reinterpret_cast<bf16*>(stage + kXStage + kWStage);
  for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreadsBf16) {
    const int r = i / (BK / 8), cv = i % (BK / 8);
    const int gm = m0 + r, gk = k0 + cv * 8;
    const bool ok = gm < a.m && gk < a.c;
    cp_async16(xs + r * LDS + cv * 8, ok ? x + (long long)gm * a.c + gk : x,
               ok);
  }
  for (int i = threadIdx.x; i < BN * (BK / 8); i += kThreadsBf16) {
    const int r = i / (BK / 8), cv = i % (BK / 8);
    const int gn = n0 + r, gk = k0 + cv * 8;
    const bool ok = gn < a.inner && gk < a.c;
    cp_async16(whs + r * LDS + cv * 8,
               ok ? w + (long long)gn * a.c + gk : w, ok);
    cp_async16(wgs + r * LDS + cv * 8,
               ok ? w + (long long)(gn + a.inner) * a.c + gk : w, ok);
  }
}

template <int GATE>
__global__ void __launch_bounds__(kThreadsBf16)
    geglu_bf16_kernel(const GegluArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: 64 rows x 32 cols
  const int g = lane >> 2, tig = lane & 3;

  // [m16 tile][n8 tile][c0..c3] for the h and the gate half
  float acc_h[4][4][4], acc_g[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[i][j][e] = acc_g[i][j][e] = 0.f;

  const int kt_n = (a.c + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kt_n) load_stage(smem + st * kStage, a, m0, n0, st * BK);
    cp_async_commit();
  }
  // ldmatrix row addresses: A rows lane%16, k half lane/16; B (two n8
  // tiles per x4) rows ((lane>>4)<<3) + (lane&7), k half (lane>>3)&1
  const int a_row = wm * 64 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = wn * 32 + ((lane >> 4) << 3) + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt-1 is free to refill
    if (kt + STAGES - 1 < kt_n)
      load_stage(smem + ((kt + STAGES - 1) % STAGES) * kStage, a, m0, n0,
                 (kt + STAGES - 1) * BK);
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(st);
    const bf16* whs = reinterpret_cast<const bf16*>(st + kXStage);
    const bf16* wgs = reinterpret_cast<const bf16*>(st + kXStage + kWStage);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bh[2][4], bg[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], xs + (a_row + mi * 16) * LDS + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldmatrix_x4(bh[np], whs + (b_row + np * 16) * LDS + kk * 16 + b_col);
        ldmatrix_x4(bg[np], wgs + (b_row + np * 16) * LDS + kk * 16 + b_col);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_16816(acc_h[mi][ni], af[mi], &bh[ni >> 1][(ni & 1) * 2]);
          mma_16816(acc_g[mi][ni], af[mi], &bg[ni >> 1][(ni & 1) * 2]);
        }
    }
  }

  // epilogue straight from the accumulators: h and gate fragments of a
  // tile share one layout, so each lane gates its own elements
  const bf16* bias = static_cast<const bf16*>(a.b);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + tig * 2;
    if (col >= a.inner) continue;  // inner % 8 == 0: col + 1 is in range
    const float bh0 = __bfloat162float(bias[col]);
    const float bh1 = __bfloat162float(bias[col + 1]);
    const float bg0 = __bfloat162float(bias[a.inner + col]);
    const float bg1 = __bfloat162float(bias[a.inner + col + 1]);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 64 + mi * 16 + g + r * 8;
        if (row >= a.m) continue;
        const float* h = &acc_h[mi][ni][r * 2];
        const float* gv = &acc_g[mi][ni][r * 2];
        *reinterpret_cast<uint32_t*>(out + (long long)row * a.inner + col) =
            pack_bf16x2((h[0] + bh0) * gate_fn<GATE>(gv[0] + bg0),
                        (h[1] + bh1) * gate_fn<GATE>(gv[1] + bg1));
      }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int kThreadsF32 = 256;
constexpr int LDF = FM + 4;

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
      out[(long long)gm * a.inner + gn] = hvv * gate_fn<GATE>(gvv);
    }
  }
}

template <int GATE>
int launch(int dtype, const GegluArgs& a, cudaStream_t s) {
  if (dtype == kBFloat16) {
    auto kern = geglu_bf16_kernel<GATE>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBf16);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a.inner + BN - 1) / BN, (a.m + BM - 1) / BM);
    kern<<<grid, kThreadsBf16, kSmemBf16, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (dtype == kFloat32) {
    dim3 grid((a.inner + FN - 1) / FN, (a.m + FM - 1) / FM);
    geglu_f32_kernel<GATE><<<grid, kThreadsF32, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  return -1;
}

}  // namespace
}  // namespace vst

extern "C" int vst_geglu_fwd(int dtype, int gate, const void* x,
                             const void* w, const void* b, void* out, int m,
                             int c, int inner, void* stream) {
  vst::GegluArgs a{x, w, b, out, m, c, inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gate) {
    case vst::kGateErf5: return vst::launch<vst::kGateErf5>(dtype, a, s);
    case vst::kGateCdf3: return vst::launch<vst::kGateCdf3>(dtype, a, s);
    case vst::kGatePoly14: return vst::launch<vst::kGatePoly14>(dtype, a, s);
    default: return -3;
  }
}
