"""Temporal (motion) transformer modules — AnimateDiff.

Counterpart of the JAX package's models/motion.py, its local path and
its frame-sharded one (``_motion_module_sharded``):

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

Under frame parallelism (a ``FrameShard``: each rank of a frame group
holds a contiguous run of every clip's frames) the module needs every
frame of a pixel. With equal frame counts and HW divisible by the group
size it exchanges frame shards for pixel shards with one all-to-all,
pools the GroupNorm statistics with two tiny all-reduces, runs the
blocks (K3, and K5 in the backward) on its pixel shard, and exchanges
back: each rank sends and receives (n-1)/n of its activation twice. Any
other split gathers the whole clip on every rank and keeps its own
frames of the result: the same math at n times the work.
"""
from __future__ import annotations

import torch

from video_style_transfer_tpu_torch.lora.temporal import apply_temporal_lora
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.models.attention import (
    feed_forward, fused_qkv_projection, init_attention, init_feed_forward)
from video_style_transfer_tpu_torch.models.embeddings import (
    temporal_positional_encoding)
from video_style_transfer_tpu_torch.ops.temporal_attention import (
    temporal_attention, temporal_attention_plain)
from video_style_transfer_tpu_torch.parallel import distributed


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


def _blocks(p, y, num_frames: int, c: int, *, heads: int,
            max_seq_length: int, remat: bool):
    """proj_in, the temporal blocks and proj_out on (F, N, C) tokens."""
    y = layers.linear(p["proj_in"], y)
    pe = temporal_positional_encoding(num_frames, c, max_len=max_seq_length,
                                      device=y.device)
    pe = pe[:, None, :].to(y.dtype)
    for bp in p["transformer_blocks"]:
        def block(y_, bp=bp):
            return motion_block(bp, y_, pe, heads=heads)
        y = layers.remat(block, y) if remat else block(y)
    return layers.linear(p["proj_out"], y)


def _group_norm_psum(p, x, *, num_groups: int, eps: float, shard):
    """GroupNorm of (B, S, C) rows whose S axis is split over the ranks
    of a FrameShard's group (equal shares): exact two-pass statistics, the
    per-channel sums all-reduced to the global mean, then the centred
    second moments to the global variance; only (B, C) statistics cross
    ranks. The affine is layers.group_norm's: x * scale + shift in f32,
    rounded once."""
    b, c = x.shape[0], x.shape[-1]
    g = num_groups
    xf = x.reshape(b, -1, c).float()
    cnt = xf.shape[1] * (c // g) * shard.size
    s1 = distributed.all_reduce_sum(xf.sum(1), shard.group)      # (B, C)
    mean = s1.view(b, g, c // g).sum(-1, keepdim=True) / cnt     # (B, g, 1)
    xc = xf.view(b, -1, g, c // g) - mean.view(b, 1, g, 1)
    s2 = distributed.all_reduce_sum((xc * xc).sum(1), shard.group)
    var = s2.sum(-1, keepdim=True) / cnt
    scale = torch.rsqrt(var + eps) * p["weight"].float().view(g, -1)
    shift = p["bias"].float().view(g, -1) - mean * scale
    y = xf.view(b, -1, g, c // g) * scale.unsqueeze(1) + shift.unsqueeze(1)
    return y.to(x.dtype).reshape(x.shape)


def _motion_module_sharded(p, x, shard, *, heads: int, norm_num_groups: int,
                           max_seq_length: int, remat: bool):
    """The frame-parallel module (equal frame counts, HW % n == 0): x is
    (b * f, H, W, C), f = F / n of each of b clips. Frame shards become
    pixel shards by one all-to-all, (F, b * HW / n, C) tokens run through
    the blocks, and the inverse exchange brings the frames back."""
    n, f = shard.size, shard.local
    bf, h, w, c = x.shape
    b = bf // f
    hw = h * w
    y = _group_norm_psum(p["norm"], x.reshape(b, f * h, w, c),
                         num_groups=norm_num_groups, eps=1e-6, shard=shard)
    # (b, f, n, HW/n, C) -> (n, f, b, HW/n, C): chunk j, this rank's
    # frames of pixel block j, goes to rank j, which stacks the ranks'
    # frame runs in order into (F, b, HW/n, C)
    send = y.reshape(b, f, n, hw // n, c).permute(2, 1, 0, 3, 4)
    y = distributed.all_to_all(send, shard.group)
    y = y.reshape(n * f, b * (hw // n), c)
    y = _blocks(p, y, n * f, c, heads=heads, max_seq_length=max_seq_length,
                remat=remat)
    # inverse: chunk s, the frames of rank s at this pixel block, goes
    # back to rank s
    y = distributed.all_to_all(y.reshape(n, f, b, hw // n, c), shard.group)
    y = y.permute(2, 1, 0, 3, 4).reshape(bf, h, w, c)
    return y + x


def _motion_module_gathered(p, x, shard, **kw):
    """Any other split: every rank gathers the whole clip (differentiably,
    through an all-to-all of the padded shards), runs the local module on
    it and keeps its own frames."""
    n, f, m = shard.size, shard.local, max(shard.counts)
    bf, h, w, c = x.shape
    b = bf // f
    xs = x.reshape(b, f, h, w, c)
    if f < m:
        xs = torch.cat([xs, xs.new_zeros((b, m - f, h, w, c))], dim=1)
    # the same padded shard to every rank: an all-gather written as an
    # all-to-all, whose backward carries each rank's gradient home
    got = distributed.all_to_all(xs.unsqueeze(0).expand(n, -1, -1, -1, -1,
                                                        -1), shard.group)
    full = torch.cat([got[r, :, :k] for r, k in enumerate(shard.counts)],
                     dim=1)                                 # (b, F, H, W, C)
    out = motion_module(p, full.reshape(-1, h, w, c),
                        num_frames=shard.frames, **kw)
    out = out.reshape(b, shard.frames, h, w, c)[:, shard.slice()]
    return out.reshape(bf, h, w, c)


def motion_module(p, x, *, num_frames: int, heads: int, norm_num_groups: int,
                  max_seq_length: int = 32, remat: bool = False,
                  frame_shard=None):
    """x: (B*F, H, W, C) (spatial batch layout). Returns the same shape.
    remat: recompute each motion block in the backward. frame_shard
    (parallel.mesh.FrameShard): x holds this rank's num_frames =
    frame_shard.local frames of each clip, and the module exchanges
    frames with the rest of its frame group."""
    bf, h, w, c = x.shape
    kw = dict(heads=heads, norm_num_groups=norm_num_groups,
              max_seq_length=max_seq_length, remat=remat)
    if frame_shard is not None and frame_shard.size > 1:
        if frame_shard.even and (h * w) % frame_shard.size == 0:
            return _motion_module_sharded(p, x, frame_shard, **kw)
        return _motion_module_gathered(p, x, frame_shard, **kw)
    b = bf // num_frames
    residual = x
    # fold frames into the spatial dims so group statistics pool over
    # frames too (GroupNorm on the (B, C, F, H, W) layout)
    y = layers.group_norm(p["norm"], x.reshape(b, num_frames * h, w, c),
                          num_groups=norm_num_groups, eps=1e-6)
    # (B, F, HW, C) -> (F, B*HW, C)
    y = y.reshape(b, num_frames, h * w, c).transpose(0, 1) \
        .reshape(num_frames, b * h * w, c)
    y = _blocks(p, y, num_frames, c, heads=heads,
                max_seq_length=max_seq_length, remat=remat)
    y = y.reshape(num_frames, b, h, w, c).transpose(0, 1).reshape(bf, h, w, c)
    return y + residual
