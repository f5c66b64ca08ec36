"""Temporal (motion) transformer modules — AnimateDiff, single device.

Counterpart of the JAX package's models/motion.py local path (the
frame-sharded `_motion_module_sharded` comes with multi-GPU):

  norm (GroupNorm eps 1e-6, statistics pooled over frames and space)
  proj_in
  transformer_blocks[k]:
      norm1 -> + sinusoidal PE -> attn1   (temporal self-attention)
      norm2 -> + sinusoidal PE -> attn2   (second temporal self-attention)
      norm3 -> ff (GEGLU)
  proj_out

Tokens are (F, N, C) inside the module. Without a temporal LoRA, q/k/v
come from one fused (C, 3P) projection as (F, N, 3P) and the
temporal-attention kernels (K3, K5) read the three segments in place;
with one (stage-2 training), each projection adds its fp32 rank-space
delta, rounded once to the activation dtype, and the kernels read the
three (F, N, P) results as (F, N, H, d) views.
"""
from __future__ import annotations

from video_style_transfer_tpu_torch.lora.temporal import apply_temporal_lora
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.models.attention import (
    feed_forward, fused_qkv_projection, init_attention, init_feed_forward)
from video_style_transfer_tpu_torch.models.embeddings import (
    temporal_positional_encoding)
from video_style_transfer_tpu_torch.ops.temporal_attention import (
    temporal_attention, temporal_attention_plain)


def init_motion_block(ini, dim: int, *, heads: int):
    return {
        "norm1": layers.init_norm(ini, dim),
        "attn1": init_attention(ini, dim, heads=heads),
        "norm2": layers.init_norm(ini, dim),
        "attn2": init_attention(ini, dim, heads=heads),
        "norm3": layers.init_norm(ini, dim),
        "ff": init_feed_forward(ini, dim),
    }


def _linear_tlora(p, x, x32=None):
    y = layers.linear(p, x)
    if "tlora" in p:
        y = y + apply_temporal_lora(p["tlora"], x, x32)
    return y


def _temporal_attention(p, x, *, heads: int):
    """x: (F, N, C) -> (F, N, C); frame-axis self-attention per pixel."""
    if all("tlora" not in p[n] and "bias" not in p[n]
           for n in ("to_q", "to_k", "to_v")):
        qkv = fused_qkv_projection(p, x)                 # (F, N, 3P)
        pdim = qkv.shape[-1] // 3
        q, k, v = qkv.split(pdim, -1)
    else:
        x32 = x.float() if any("tlora" in p[n]
                               for n in ("to_q", "to_k", "to_v")) else None
        q, k, v = (_linear_tlora(p[n], x, x32) for n in ("to_q", "to_k",
                                                         "to_v"))
        pdim = q.shape[-1]
    d = pdim // heads
    q, k, v = (t.unflatten(-1, (heads, d)) for t in (q, k, v))
    if d % 8 == 0:
        o = temporal_attention(q, k, v)
    else:
        # head_dim not a multiple of 8 (tiny test configs): the JAX
        # package routes these to its XLA reference, so the port takes
        # the plain version whatever the device
        o = temporal_attention_plain(q, k, v, d ** -0.5)
    return _linear_tlora(p["to_out"], o)


def motion_block(p, x, pe, *, heads: int):
    """x: (F, N, C), pe: (F, 1, C); the PE is added to the post-norm
    activations before each attention."""
    h = layers.layer_norm(p["norm1"], x) + pe
    x = x + _temporal_attention(p["attn1"], h, heads=heads)
    h = layers.layer_norm(p["norm2"], x) + pe
    x = x + _temporal_attention(p["attn2"], h, heads=heads)
    h = layers.layer_norm(p["norm3"], x)
    return x + feed_forward(p["ff"], h)


def init_motion_module(ini, in_channels: int, *, num_layers: int = 1,
                       heads: int = 8):
    return {
        "norm": layers.init_norm(ini, in_channels),
        "proj_in": layers.init_linear(ini, in_channels, in_channels),
        "transformer_blocks": [init_motion_block(ini, in_channels,
                                                 heads=heads)
                               for _ in range(num_layers)],
        "proj_out": layers.init_linear(ini, in_channels, in_channels),
    }


def motion_module(p, x, *, num_frames: int, heads: int, norm_num_groups: int,
                  max_seq_length: int = 32, remat: bool = False):
    """x: (B*F, H, W, C) (spatial batch layout). Returns the same shape.
    remat: recompute each motion block in the backward."""
    bf, h, w, c = x.shape
    b = bf // num_frames
    residual = x
    # fold frames into the spatial dims so group statistics pool over
    # frames too (GroupNorm on the (B, C, F, H, W) layout)
    y = layers.group_norm(p["norm"], x.reshape(b, num_frames * h, w, c),
                          num_groups=norm_num_groups, eps=1e-6)
    # (B, F, HW, C) -> (F, B*HW, C)
    y = y.reshape(b, num_frames, h * w, c).transpose(0, 1) \
        .reshape(num_frames, b * h * w, c)
    y = layers.linear(p["proj_in"], y)
    pe = temporal_positional_encoding(num_frames, c, max_len=max_seq_length,
                                      device=y.device)
    pe = pe[:, None, :].to(y.dtype)
    for bp in p["transformer_blocks"]:
        def block(y_, bp=bp):
            return motion_block(bp, y_, pe, heads=heads)
        y = layers.remat(block, y) if remat else block(y)
    y = layers.linear(p["proj_out"], y)
    y = y.reshape(num_frames, b, h, w, c).transpose(0, 1).reshape(bf, h, w, c)
    return y + residual
