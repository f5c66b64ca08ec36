"""Scaled-dot-product attention dispatch (the JAX package's rules, with
"tensor is on CUDA" in place of "the backend is a TPU"):

- seq_k <= 128 (cross-attention's 77 text tokens): the short-kv plain
  path, no kernel;
- else seq_q >= 1024 and head_dim % 64 == 0 and head_dim <= 512 on a CUDA
  tensor: the flash-attention kernel (K1);
- else the plain path.

All entry points take (B, S, H, D) q/k/v and return the same layout.
"""
from __future__ import annotations

from typing import Optional

import torch

from video_style_transfer_tpu_torch.ops import flash_attention as fa

_FLASH_MIN_SEQ = 1024
_SHORT_KV_MAX = 128


def sdpa_plain(q, k, v, *, scale: Optional[float] = None):
    """Reference-math attention: f32 logits and softmax, weights rounded
    to the input dtype for the value product (the JAX `sdpa_xla`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def sdpa_shortkv(q, k, v, *, scale: Optional[float] = None):
    """Short-kv attention: identical math to `sdpa_plain`; separate so
    the dispatch mirrors the JAX package route for route."""
    return sdpa_plain(q, k, v, scale=scale)


def _flash_ok(seq_q: int, head_dim: int) -> bool:
    return (seq_q >= _FLASH_MIN_SEQ and head_dim % 64 == 0
            and head_dim <= 512)


def sdpa(q, k, v, *, impl: str = "auto"):
    """q, k, v: (B, S, H, D). Returns (B, S, H, D). impl: "auto",
    "flash", "shortkv" or "plain"."""
    if impl == "auto":
        if k.shape[1] <= _SHORT_KV_MAX:
            impl = "shortkv"
        elif q.is_cuda and _flash_ok(q.shape[1], q.shape[-1]):
            impl = "flash"
        else:
            impl = "plain"
    if impl == "flash":
        return fa.flash_attention(q, k, v)
    if impl == "shortkv":
        return sdpa_shortkv(q, k, v)
    return sdpa_plain(q, k, v)


def sdpa_fused_qkv(qkv, num_heads: int, *, impl: str = "auto"):
    """Self-attention straight off a fused projection: qkv (B, S, 3*H*D)
    -> (B, S, H*D). On the flash route the kernel reads the three
    segments in place; otherwise they are split and routed through
    `sdpa`."""
    b, s, hd3 = qkv.shape
    hd = hd3 // 3
    d = hd // num_heads
    if impl == "flash" or (impl == "auto" and qkv.is_cuda
                           and _flash_ok(s, d)):
        return fa.flash_attention_qkv(qkv, num_heads)
    q, k, v = qkv.split(hd, dim=-1)
    o = sdpa(split_heads(q, num_heads), split_heads(k, num_heads),
             split_heads(v, num_heads), impl=impl)
    return merge_heads(o)


def split_heads(x, num_heads: int):
    """(B, S, H*D) -> (B, S, H, D)"""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads))


def merge_heads(x):
    """(B, S, H, D) -> (B, S, H*D)"""
    return x.flatten(-2)
