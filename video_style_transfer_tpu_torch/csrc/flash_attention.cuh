// K1's launch arguments, shared by its three routes.
#pragma once

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

// bf16 at head_dim 64, 128, 192 or 256: the wgmma + TMA route
// (flash_attention_sm90.cu). Returns 0, a CUDA error, or a negative code
// for an argument it refuses.
int flash_fwd_sm90(int head_dim, const FlashArgs& a, cudaStream_t stream);

// fp32 at head_dim 512: the FMA route (flash_attention_f32.cu). With
// kv_splits > 1 each split of the kv walk writes its partial output and
// lse to `part` ((splits, B, H, Sq, D) f32, then (splits, B, H, Sq)) and a
// second kernel combines them. Returns as flash_fwd_sm90 does.
int flash_fwd_f32(const FlashArgs& a, int kv_splits, float* part,
                  cudaStream_t stream);

}  // namespace vst
