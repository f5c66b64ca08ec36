"""SDXL UNet2DCondition with AnimateDiff motion modules — functional, NHWC.

Counterpart of the JAX package's models/unet.py: one init/apply pair over
a params dict whose keys mirror diffusers module paths
(down_blocks[i]["attentions"][j]...), with the motion modules as
first-class sub-modules gated by ``cfg.use_motion_modules``, the
UnZipLoRA ``mode`` and ``state`` threaded to every spatial attention and
block-level rematerialisation on ``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from video_style_transfer_tpu_torch.config import CROSS, UNetConfig
from video_style_transfer_tpu_torch.lora.surgery import sub
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.models.embeddings import (
    init_timestep_embedding, sdxl_add_embedding, sinusoidal_embedding,
    timestep_embedding)
from video_style_transfer_tpu_torch.models.motion import (
    init_motion_module, motion_module)
from video_style_transfer_tpu_torch.models.resnet import (
    downsample, init_downsample, init_resnet_block, init_upsample,
    resnet_block, upsample)
from video_style_transfer_tpu_torch.models.transformer import (
    init_transformer_2d, transformer_2d, transformer_2d_cross_kv)


def init_unet(ini, cfg: UNetConfig):
    ch = cfg.block_out_channels
    temb = cfg.time_embed_dim
    p = {
        "conv_in": layers.init_conv(ini, cfg.in_channels, ch[0], 3),
        "time_embedding": init_timestep_embedding(ini, ch[0], temb),
        "add_embedding": init_timestep_embedding(
            ini, cfg.projection_class_embeddings_input_dim, temb),
    }

    def motion(c):
        return init_motion_module(
            ini, c, num_layers=cfg.motion_transformer_layers_per_block,
            heads=cfg.motion_num_attention_heads)

    def tf(c, idx):
        return init_transformer_2d(
            ini, c, num_layers=cfg.transformer_layers_per_block[idx],
            heads=cfg.num_attention_heads[idx],
            cross_attention_dim=cfg.cross_attention_dim)

    down = []
    out_c = ch[0]
    for i, btype in enumerate(cfg.down_block_types):
        in_c, out_c = out_c, ch[i]
        block = {"resnets": [], "attentions": [], "motion_modules": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(init_resnet_block(
                ini, in_c if j == 0 else out_c, out_c, temb_channels=temb))
            if btype == CROSS:
                block["attentions"].append(tf(out_c, i))
            if cfg.use_motion_modules:
                block["motion_modules"].append(motion(out_c))
        if i < len(cfg.down_block_types) - 1:
            block["downsamplers"] = [init_downsample(ini, out_c)]
        down.append(block)
    p["down_blocks"] = down

    mid_c = ch[-1]
    p["mid_block"] = {
        "resnets": [init_resnet_block(ini, mid_c, mid_c, temb_channels=temb)
                    for _ in range(2)],
        "attentions": [tf(mid_c, -1)],
    }
    if cfg.use_motion_modules and cfg.motion_mid_block:
        p["mid_block"]["motion_modules"] = [motion(mid_c)]

    skip = [ch[0]]
    for i in range(len(cfg.down_block_types)):
        skip += [ch[i]] * cfg.layers_per_block
        if i < len(cfg.down_block_types) - 1:
            skip.append(ch[i])
    up = []
    rev = list(reversed(ch))
    cur = mid_c
    for i, btype in enumerate(cfg.up_block_types):
        out_c = rev[i]
        tf_idx = len(ch) - 1 - i
        block = {"resnets": [], "attentions": [], "motion_modules": []}
        for _ in range(cfg.layers_per_block + 1):
            block["resnets"].append(init_resnet_block(
                ini, cur + skip.pop(), out_c, temb_channels=temb))
            cur = out_c
            if btype == CROSS:
                block["attentions"].append(tf(out_c, tf_idx))
            if cfg.use_motion_modules:
                block["motion_modules"].append(motion(out_c))
        if i < len(cfg.up_block_types) - 1:
            block["upsamplers"] = [init_upsample(ini, out_c)]
        up.append(block)
    p["up_blocks"] = up
    p["conv_norm_out"] = layers.init_norm(ini, ch[0])
    p["conv_out"] = layers.init_conv(ini, ch[0], cfg.out_channels, 3)
    return p


def precompute_cross_kv(params, cfg: UNetConfig, ctx: Tuple, *,
                        mode: str = "base", state=None, dtype=None,
                        num_frames: int = 1):
    """Every cross-attention's prompt-side k/v, evaluated once (they are
    invariant across denoise steps), with the UnZipLoRA branches of to_k
    and to_v under `mode` and `state`. ctx: (combined, content, style),
    each (B, S, cross_attention_dim), not frame-repeated; num_frames bakes
    the frame repeat into the cache. Returns a dict keyed like params."""
    if dtype is not None:
        ctx = tuple(None if e is None else e.to(dtype) for e in ctx)
    if num_frames > 1:
        ctx = tuple(None if e is None
                    else e.repeat_interleave(num_frames, dim=0) for e in ctx)
    cache = {"down_blocks": {}, "up_blocks": {}}
    for path, types in (("down_blocks", cfg.down_block_types),
                        ("up_blocks", cfg.up_block_types)):
        for i, block in enumerate(params[path]):
            if types[i] == CROSS:
                cache[path][i] = [
                    transformer_2d_cross_kv(
                        ap, ctx, mode=mode,
                        state=sub(state, path, i, "attentions", j))
                    for j, ap in enumerate(block["attentions"])]
    cache["mid_block"] = [transformer_2d_cross_kv(
        params["mid_block"]["attentions"][0], ctx, mode=mode,
        state=sub(state, "mid_block", "attentions", 0))]
    return cache


def _kv(cross_kv, path, i, j):
    if cross_kv is None:
        return None
    if path == "mid_block":
        return cross_kv["mid_block"][j]
    return cross_kv[path][i][j]


def unet_apply(params, cfg: UNetConfig, sample, timesteps, ctx: Tuple,
               pooled_text, time_ids, *, num_frames: int = 1,
               cross_kv=None, mode: str = "base", state=None,
               remat: bool = False, frame_shard=None):
    """Denoiser forward.

    sample:      (N, H, W, C_in) NHWC, N = batch * num_frames
    timesteps:   scalar or (B,)
    ctx:         (combined, content, style) prompt embeddings, each
                 (B, S, cross_attention_dim)
    pooled_text: (B, pooled_dim); time_ids: (B, 6)
    cross_kv:    optional precompute_cross_kv output
    mode, state: UnZipLoRA mode and state tree (insert_unziplora's)
    remat:       recompute each transformer and motion block in the
                 backward (the JAX package's remat=True); False stores
                 every activation
    frame_shard: parallel.mesh.FrameShard under frame parallelism:
                 sample holds this rank's num_frames (= frame_shard.local)
                 frames of each clip; the motion modules exchange frames
                 across its group, every other layer is per frame and
                 stays local
    """
    n = sample.shape[0]
    b = n // num_frames
    dt = sample.dtype
    dev = sample.device

    ts = torch.as_tensor(timesteps, device=dev)
    if ts.dim() == 0:
        ts = ts.expand(b)
    t_emb = sinusoidal_embedding(ts, cfg.block_out_channels[0],
                                 flip_sin_to_cos=cfg.flip_sin_to_cos,
                                 freq_shift=cfg.freq_shift)
    # f32 conditioning math (weights cast up at use), cast at the end
    emb = timestep_embedding(params["time_embedding"], t_emb)
    emb = emb + sdxl_add_embedding(
        params["add_embedding"], pooled_text, time_ids,
        addition_time_embed_dim=cfg.addition_time_embed_dim,
        flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift)
    if num_frames > 1:
        emb = emb.repeat_interleave(num_frames, dim=0)
    emb = emb.to(dt)

    if cross_kv is None:
        def rep(e):
            if e is None:
                return None
            if e.shape[0] != n:
                e = e.repeat_interleave(num_frames, dim=0)
            return e.to(dt)
        ctx = tuple(rep(e) for e in ctx)
    else:
        ctx = None

    groups = cfg.norm_num_groups
    motion_on = cfg.use_motion_modules and (
        frame_shard.frames if frame_shard is not None else num_frames) > 1

    def resnet(rp, h):
        return resnet_block(rp, h, emb, num_groups=groups, eps=cfg.norm_eps)

    def attn(ap, h, kv, heads, st):
        return transformer_2d(ap, h, ctx, heads=heads,
                              norm_num_groups=groups, cross_kv=kv,
                              mode=mode, state=st, remat=remat)

    def motion(mm, h):
        return motion_module(mm, h, num_frames=num_frames,
                             heads=cfg.motion_num_attention_heads,
                             norm_num_groups=groups,
                             max_seq_length=cfg.motion_max_seq_length,
                             remat=remat, frame_shard=frame_shard)

    h = layers.conv2d(params["conv_in"], sample)
    skips = [h]
    for i, block in enumerate(params["down_blocks"]):
        for j, rp in enumerate(block["resnets"]):
            h = resnet(rp, h)
            if cfg.down_block_types[i] == CROSS:
                h = attn(block["attentions"][j], h,
                         _kv(cross_kv, "down_blocks", i, j),
                         cfg.num_attention_heads[i],
                         sub(state, "down_blocks", i, "attentions", j))
            if motion_on and block.get("motion_modules"):
                h = motion(block["motion_modules"][j], h)
            skips.append(h)
        if "downsamplers" in block:
            h = downsample(block["downsamplers"][0], h)
            skips.append(h)

    mid = params["mid_block"]
    h = resnet(mid["resnets"][0], h)
    h = attn(mid["attentions"][0], h, _kv(cross_kv, "mid_block", 0, 0),
             cfg.num_attention_heads[-1],
             sub(state, "mid_block", "attentions", 0))
    if motion_on and mid.get("motion_modules"):
        h = motion(mid["motion_modules"][0], h)
    h = resnet(mid["resnets"][1], h)

    for i, block in enumerate(params["up_blocks"]):
        tf_idx = len(cfg.block_out_channels) - 1 - i
        for j, rp in enumerate(block["resnets"]):
            h = resnet(rp, torch.cat([h, skips.pop()], dim=-1))
            if cfg.up_block_types[i] == CROSS:
                h = attn(block["attentions"][j], h,
                         _kv(cross_kv, "up_blocks", i, j),
                         cfg.num_attention_heads[tf_idx],
                         sub(state, "up_blocks", i, "attentions", j))
            if motion_on and block.get("motion_modules"):
                h = motion(block["motion_modules"][j], h)
        if "upsamplers" in block:
            h = upsample(block["upsamplers"][0], h)

    h = layers.silu(layers.group_norm(params["conv_norm_out"], h,
                                      num_groups=groups, eps=cfg.norm_eps))
    return layers.conv2d(params["conv_out"], h)
