"""K1: flash-attention forward — CUDA kernel (csrc/flash_attention.cu)
and its plain PyTorch version.

Replaces the JAX package's ops/flash_attention.py Pallas kernels
(`_attn_kernel_packed_single`, `_attn_kernel_packed`). On the H100 the
kernel is bound by tensor-core (bf16) or FMA (fp32) throughput; see the
source for its design. The TPU's head packing, MXU row-sum and block
tuning have no counterpart: the kernel reads (B, S, H, D) strided views,
so the fused (B, S, 3*H*D) projection is consumed in place.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version. The backward is the training slice's work.
"""
from __future__ import annotations

import math

import torch

from video_style_transfer_tpu_torch.ops import cuda_build

# launches of the CUDA kernel in this process (the plain version and
# refused calls do not count)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512)


def flash_attention_plain(q, k, v, scale: float):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (out (B, Sq, H*D) in q's
    dtype, lse (B, H, Sq) f32, natural log): f32 softmax over explicit
    matmuls."""
    b, sq, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype).reshape(b, sq, h * d), lse


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash attention: q, k, v must all be on CUDA")
    if not (q.device == k.device == v.device):
        raise ValueError("flash attention: q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes (B, S, H, D) views")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash attention shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention head_dim {d} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention: {name} needs unit stride "
                             f"along D")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} strides/pointer not "
                             f"16-byte aligned")
    if max(sq, k.shape[1]) >= 2 ** 31 or b > 65535 or h > 65535:
        raise ValueError("flash attention: shape beyond the launch grid")


def flash_attention_fwd(q, k, v, *, scale=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D), any strides with unit D
    stride. Returns (out (B, Sq, H*D), lse (B, H, Sq) f32)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.vst_flash_attention_fwd(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, sk, h,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), cuda_build.stream_of(q))
    cuda_build.check_launch("flash_attention_fwd", err)
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, _ = flash_attention_fwd(q, k, v, scale=scale)
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash attention backward is the training slice")


def flash_attention_bshd(q, k, v, *, scale=None):
    """q, k, v: (B, S, H, D) -> (B, Sq, H*D); differentiable only in
    the sense that asking for a gradient raises."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, float(scale))


def flash_attention(q, k, v, *, scale=None):
    """q, k, v: (B, S, H, D) -> (B, S, H, D) (the JAX `flash_attention`
    signature)."""
    b, sq, h, d = q.shape
    return flash_attention_bshd(q, k, v, scale=scale).reshape(b, sq, h, d)


def flash_attention_qkv(qkv, num_heads: int, *, scale=None):
    """Self-attention over a fused projection: qkv (B, S, 3*H*D) ->
    (B, S, H*D). The q, k and v segments are strided views of qkv; the
    kernel reads them in place."""
    b, s, hd3 = qkv.shape
    hd = hd3 // 3
    d = hd // num_heads
    q = qkv[..., :hd].unflatten(-1, (num_heads, d))
    k = qkv[..., hd:2 * hd].unflatten(-1, (num_heads, d))
    v = qkv[..., 2 * hd:].unflatten(-1, (num_heads, d))
    return flash_attention_bshd(q, k, v, scale=scale)
