// K1's launch arguments, shared by its four routes, K4's, and the pieces
// their sources share.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace vst {

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int batch, seq_q, seq_k, heads;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
};

// K4's launch arguments: q, k, v (B, S, H, D) strided views (strides in
// elements), dO (B, Sq, H*D) contiguous, the saved lse and delta (B, H,
// Sq) f32, dq, dk, dv written (B, S, H, D) contiguous.
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

// The arguments of one K1 call as ops/flash_attention.py packs them
// (`_FWD_POINTERS`, `_FWD_LAYOUT`, `_FWD_SCALE`: "<7Q", "<9q8i", "<f";
// no padding before `scale`):
// pointers and the stream, the q, k, v strides (elements; batch, seq,
// head), the device the call is for, then the scalars. `part` is the FMA
// route's split buffer or null.
struct FwdCall {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  void* part;
  void* stream;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int device, dtype, head_dim, batch, seq_q, seq_k, heads, kv_splits;
  float scale;
};

// The launch arguments of a route that splits its kv walk (fp32 d >= 128,
// bf16 d >= 320) into `kv_splits` parts of `tiles_per_split` kv tiles;
// with kv_splits > 1 each split writes its normalised output and lse to
// `part` ((splits, B, H, Sq, D) f32, then (splits, B, H, Sq)).
struct SplitArgs {
  FlashArgs a;
  int kv_splits;
  int tiles_per_split;
  float* part;
};

// The split arguments for a kv walk of `n_tiles` tiles, or -2 in
// `kv_splits` where the call cannot split so: every split must own at
// least one tile, and a split walk needs `part`.
inline SplitArgs split_args(const FlashArgs& a, int n_tiles, int kv_splits,
                            float* part) {
  const int per = n_tiles > 0 && kv_splits > 0
                      ? (n_tiles + kv_splits - 1) / kv_splits : 0;
  const bool ok = a.seq_k >= 1 && kv_splits >= 1 && kv_splits <= n_tiles &&
                  (kv_splits == 1 || part != nullptr) &&
                  (long long)(kv_splits - 1) * per < n_tiles &&
                  (long long)a.heads * kv_splits <= 65535;
  return SplitArgs{a, ok ? kv_splits : -2, per, part};
}

// bf16 at head_dim 64, 128, 192 or 256: the wgmma + TMA route
// (flash_attention_sm90.cu). Returns 0, a CUDA error, or a negative code
// for an argument it refuses.
int flash_fwd_sm90(int head_dim, const FlashArgs& a, cudaStream_t stream);

// bf16 at head_dim 320, 384, 448 or 512: the wgmma + TMA route's kernel
// with O split across two consumer warpgroups (flash_attention_wide.cu).
// With kv_splits > 1 each split of the kv walk writes its partial output
// and lse to `part` ((splits, B, H, Sq, D) f32, then (splits, B, H, Sq))
// for flash_combine. Returns as flash_fwd_sm90 does.
int flash_fwd_sm90_wide(int head_dim, const FlashArgs& a, int kv_splits,
                        float* part, cudaStream_t stream);

// fp32 at head_dim 128, 192, 256, 320, 384, 448 or 512: the FMA route
// (flash_attention_f32.cu); `part` as flash_fwd_sm90_wide's. Returns as
// flash_fwd_sm90 does.
int flash_fwd_f32(int head_dim, const FlashArgs& a, int kv_splits,
                  float* part, cudaStream_t stream);

// fp32 at head_dim 64: the 3xTF32 tensor-core route
// (flash_attention_tf32.cu). Returns as flash_fwd_sm90 does.
int flash_fwd_tf32(const FlashArgs& a, cudaStream_t stream);

// K4's fp32 dk/dv and dq kernels at head_dim 64, on the same route
// (flash_attention_tf32.cu), from the delta that flash_attention_bwd.cu's
// kernel wrote. Returns as flash_fwd_sm90 does.
int flash_bwd_tf32(const BwdArgs& a, cudaStream_t stream);

// K4 at head_dim 128-512 with D split, from the delta that
// flash_attention_bwd.cu's kernel wrote, each block of a cluster a slice
// of at most 128 output columns: bf16 on wgmma + TMA
// (flash_attention_bwd_sliced.cu), fp32 at 3xTF32 on TF32 wgmma
// (flash_attention_bwd_sliced_tf32.cu). Return as flash_fwd_sm90 does.
int flash_bwd_sliced_sm90(const BwdArgs& a, int head_dim,
                          cudaStream_t stream);
int flash_bwd_sliced_tf32(const BwdArgs& a, int head_dim,
                          cudaStream_t stream);

// Merges the kv splits' partial outputs and lse in `part` by their lse
// into out (in `dtype`) and lse (flash_attention.cu).
int flash_combine(const FlashArgs& a, int dtype, int head_dim, int splits,
                  const float* part, cudaStream_t stream);

// The encoded bf16 q, k and v maps of the wgmma routes: 4-D (D, H, S, B),
// boxes of 64 values of D (one 128-byte swizzled panel) by `q_rows` or
// `kv_rows` rows (flash_attention_sm90.cu). Returns 0, a negative code,
// or -1000 - a CUresult.
int qkv_maps(const FlashArgs& a, int d, int q_rows, int kv_rows,
             CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv);

}  // namespace vst
