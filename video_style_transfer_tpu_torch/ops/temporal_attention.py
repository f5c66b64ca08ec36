"""K3: per-pixel temporal (frame-axis) attention forward — CUDA kernel
(csrc/temporal_attention.cu) and its plain PyTorch version.

Replaces the JAX package's ops/temporal_attention.py Pallas kernel
(`_kernel`). The motion module keeps tokens as (F, N, C), so q/k/v come
out of one (C, 3P) projection as (F, N, 3P) and reach the kernel as
(F, N, H, d) strided views; the output is (F, N, P). The JAX package's
per-frame (P, N) lists are a TPU lane-layout choice with no counterpart
here. On the H100 the kernel is bound by device-memory bandwidth; see
the source for its design.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version.
"""
from __future__ import annotations

import math

import torch

from video_style_transfer_tpu_torch.ops import cuda_build

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FRAMES = 32


def temporal_attention_plain(q, k, v, scale: float):
    """q, k, v: (F, N, H, d) -> (F, N, H*d): softmax over the frame axis
    per pixel and head (the einsum form of the JAX `_reference_stacked`:
    f32 logits and accumulation, weights rounded to v's dtype)."""
    f, n, h, d = q.shape
    logits = torch.einsum("fnhd,gnhd->nhfg", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhfg,gnhd->fnhd", w.to(v.dtype).float(), v.float())
    return o.to(q.dtype).reshape(f, n, h * d)


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("temporal attention: q, k, v must all be on CUDA")
    if not (q.device == k.device == v.device):
        raise ValueError("temporal attention: q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"temporal attention takes float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("temporal attention takes equal (F, N, H, d) views")
    f, n, h, d = q.shape
    if not 1 <= f <= MAX_FRAMES:
        raise ValueError(f"temporal attention: {f} frames, at most "
                         f"{MAX_FRAMES}")
    vec = 16 // q.element_size()
    if d % 8:
        raise ValueError(f"temporal attention: head_dim {d} is not a "
                         f"multiple of 8")
    if 3 * f * d * q.element_size() > 48 * 1024:
        raise ValueError("temporal attention: one (pixel, head) pair "
                         "exceeds the kernel's shared-memory tile")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"temporal attention: {name} needs unit "
                             f"stride along d")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"temporal attention: {name} strides/pointer "
                             f"not 16-byte aligned")
    if n * h >= 2 ** 31:
        raise ValueError("temporal attention: N*H beyond the launch grid")


def temporal_attention(q, k, v, *, scale=None):
    """q, k, v: (F, N, H, d) views -> (F, N, H*d)."""
    f, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, scale)
    _check(q, k, v)
    out = torch.empty((f, n, h * d), dtype=q.dtype, device=q.device)
    lib = cuda_build.library()
    with torch.cuda.device(q.device):
        err = lib.vst_temporal_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), f, n, h, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), cuda_build.stream_of(q))
    cuda_build.check_launch("temporal_attention", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


def temporal_attention_qkv(qkv, num_heads: int, *, scale=None):
    """qkv: (F, N, 3P) fused projection -> (F, N, P); the q, k and v
    segments are strided views read in place."""
    p = qkv.shape[-1] // 3
    d = p // num_heads
    q = qkv[..., :p].unflatten(-1, (num_heads, d))
    k = qkv[..., p:2 * p].unflatten(-1, (num_heads, d))
    v = qkv[..., 2 * p:].unflatten(-1, (num_heads, d))
    return temporal_attention(q, k, v, scale=scale)
