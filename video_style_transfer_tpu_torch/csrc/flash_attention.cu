// K1: flash-attention forward, the routes' shared pieces: the kv-split
// combine that the FMA route (flash_attention_f32.cu: fp32 d from 128 to
// 512) and the wide wgmma route (flash_attention_wide.cu: bf16 d >= 320)
// share, and the C entry point, which sends each call to its route (bf16
// d <= 256: flash_attention_sm90.cu; fp32 d = 64: the 3xTF32 route of
// flash_attention_tf32.cu).
//
// The kernels replace the JAX package's Pallas kernels
// ops/flash_attention.py `_attn_kernel_packed_single` /
// `_attn_kernel_packed` (launched by `_flash_fwd_bs_hd` and
// `_flash_fwd_qkv_packed`) and `_attn_kernel` (`_flash_fwd_bhsd`): per
// (batch, head), out = softmax(q k^T * scale) v and the natural-log
// log-sum-exp of each query row, reading q, k and v as (B, S, H, D)
// strided views (so the fused (B, S, 3*H*D) projection is read in place)
// and writing out (B, S, H*D) and lse (B, H, S).
//
// The combine is bound by its bytes: each split's D-wide f32 row and lse
// read once, the merged row written once.

#include <cstddef>

#include "common.cuh"
#include "flash_attention.cuh"

namespace vst {
namespace {

// out = sum_s exp(lse_s - lse) o_s, lse = log sum_s exp(lse_s): one block
// of D / 4 threads a (batch, head, query) row, 4 values of D each, out in
// T
template <typename T>
__global__ void __launch_bounds__(128)
    flash_combine_kernel(const FlashArgs a, int d, int splits,
                         const float* part) {
  const long long rows = (long long)a.batch * a.heads * a.seq_q;
  const long long row = blockIdx.x;  // (b, h, q)
  const float* plse = part + rows * d * splits + row;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, plse[s * rows]);
  float wsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float w = expf(plse[s * rows] - m);
    const float4 v = *reinterpret_cast<const float4*>(
        part + (s * rows + row) * d + 4 * threadIdx.x);
    wsum += w;
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
  }
  const float inv = 1.f / wsum;
  const int q = static_cast<int>(row % a.seq_q);
  const long long bh = row / a.seq_q;
  const int h = static_cast<int>(bh % a.heads);
  const long long b = bh / a.heads;
  T* o = static_cast<T*>(a.o) + (b * a.seq_q + q) * a.heads * d + h * d +
         4 * threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(o) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  } else {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(pack_bf16x2(acc.x * inv, acc.y * inv),
                   pack_bf16x2(acc.z * inv, acc.w * inv));
  }
  if (threadIdx.x == 0) a.lse[row] = m + logf(wsum);
}

// --------------------------------------------------------------- route

// One K1 call on the current device, by route; the routes that split the
// kv walk (fp32 d >= 128, bf16 d >= 320) merge their splits after.
int flash_fwd(const FwdCall& c) {
  FlashArgs a{c.q,    c.k,    c.v,    c.o,    static_cast<float*>(c.lse),
              c.batch, c.seq_q, c.seq_k, c.heads, c.q_sb, c.q_ss, c.q_sh,
              c.k_sb, c.k_ss, c.k_sh, c.v_sb, c.v_ss, c.v_sh, c.scale};
  cudaStream_t s = static_cast<cudaStream_t>(c.stream);
  const int d = c.head_dim;
  float* part = static_cast<float*>(c.part);
  int err;
  if (c.dtype == kFloat32 && d >= 128) {
    err = flash_fwd_f32(d, a, c.kv_splits, part, s);
  } else if (c.dtype == kBFloat16 && d >= 320) {
    err = flash_fwd_sm90_wide(d, a, c.kv_splits, part, s);
  } else {
    if (c.kv_splits != 1) return -2;  // the other routes do not split
    if (c.dtype == kFloat32) return d == 64 ? flash_fwd_tf32(a, s) : -2;
    if (c.dtype == kBFloat16) return flash_fwd_sm90(d, a, s);
    return -1;
  }
  if (err != 0 || c.kv_splits == 1) return err;
  return flash_combine(a, c.dtype, d, c.kv_splits, part, s);
}

}  // namespace

int flash_combine(const FlashArgs& a, int dtype, int head_dim, int splits,
                  const float* part, cudaStream_t stream) {
  if (head_dim % 4 != 0 || head_dim / 4 > 128 || splits < 2) return -2;
  const long long rows = (long long)a.batch * a.heads * a.seq_q;
  if (rows > 0x7fffffff) return -2;
  if (dtype == kFloat32)
    flash_combine_kernel<float><<<(unsigned)rows, head_dim / 4, 0, stream>>>(
        a, head_dim, splits, part);
  else if (dtype == kBFloat16)
    flash_combine_kernel<bf16><<<(unsigned)rows, head_dim / 4, 0, stream>>>(
        a, head_dim, splits, part);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace vst

static_assert(offsetof(vst::FwdCall, scale) == 160,
              "FwdCall must match ops/flash_attention.py's packing");

// One K1 call from its packed arguments: launched on the call's device,
// made current for the launch where another one is.
extern "C" int vst_flash_attention_fwd(const vst::FwdCall* call) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  if (current == call->device) return vst::flash_fwd(*call);
  e = cudaSetDevice(call->device);
  if (e != cudaSuccess) return (int)e;
  const int err = vst::flash_fwd(*call);
  e = cudaSetDevice(current);
  return err != 0 ? err : (int)e;
}
