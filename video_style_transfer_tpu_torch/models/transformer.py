"""Spatial transformer stack: BasicTransformerBlock + Transformer2DModel
(use_linear_projection=True, the SDXL layout), NHWC. The JAX package's
stacked blocks under ``lax.scan`` become a list of per-layer param dicts
walked by a loop."""
from __future__ import annotations

from typing import Tuple

from video_style_transfer_tpu_torch.lora.surgery import sub
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.models.attention import (
    attention, cross_attention_kv, feed_forward, init_attention,
    init_feed_forward)


def init_transformer_block(ini, dim: int, *, heads: int,
                           cross_attention_dim: int):
    return {
        "norm1": layers.init_norm(ini, dim),
        "attn1": init_attention(ini, dim, heads=heads),
        "norm2": layers.init_norm(ini, dim),
        "attn2": init_attention(ini, dim, heads=heads,
                                cross_attention_dim=cross_attention_dim),
        "norm3": layers.init_norm(ini, dim),
        "ff": init_feed_forward(ini, dim),
    }


def transformer_block(p, x, ctx: Tuple, *, heads: int, kv2=None,
                      mode: str = "base", state=None):
    """x: (N, S, C); ctx: (combined, content, style) encoder states;
    kv2: optional precomputed cross-attention (k, v); state: this
    layer's UnZipLoRA state ({"attn1": ..., "attn2": ...})."""
    st = state or {}
    h = layers.layer_norm(p["norm1"], x)
    x = x + attention(p["attn1"], h, None, heads=heads, mode=mode,
                      state=st.get("attn1"))
    h = layers.layer_norm(p["norm2"], x)
    x = x + attention(p["attn2"], h, ctx, heads=heads, kv=kv2, mode=mode,
                      state=st.get("attn2"))
    h = layers.layer_norm(p["norm3"], x)
    return x + feed_forward(p["ff"], h)


def transformer_2d_cross_kv(p, ctx: Tuple, *, mode: str = "base",
                            state=None):
    """Per-layer attn2 (k, v) of one transformer_2d, a list. state: this
    transformer_2d's UnZipLoRA state."""
    return [cross_attention_kv(
        bp["attn2"], ctx, mode=mode,
        state=sub(state, "transformer_blocks", i, "attn2"))
        for i, bp in enumerate(p["transformer_blocks"])]


def init_transformer_2d(ini, in_channels: int, *, num_layers: int,
                        heads: int, cross_attention_dim: int):
    return {
        "norm": layers.init_norm(ini, in_channels),
        "proj_in": layers.init_linear(ini, in_channels, in_channels),
        "transformer_blocks": [
            init_transformer_block(ini, in_channels, heads=heads,
                                   cross_attention_dim=cross_attention_dim)
            for _ in range(num_layers)],
        "proj_out": layers.init_linear(ini, in_channels, in_channels),
    }


def transformer_2d(p, x, ctx: Tuple, *, heads: int, norm_num_groups: int,
                   cross_kv=None, mode: str = "base", state=None,
                   remat: bool = False):
    """x: (N, H, W, C). cross_kv: optional per-layer list of precomputed
    attn2 (k, v) pairs. remat: recompute each layer in the backward."""
    n, h, w, c = x.shape
    residual = x
    # diffusers Transformer2DModel hard-codes GroupNorm eps=1e-6
    y = layers.group_norm(p["norm"], x, num_groups=norm_num_groups, eps=1e-6)
    y = layers.linear(p["proj_in"], y.reshape(n, h * w, c))
    for i, bp in enumerate(p["transformer_blocks"]):
        def layer(y_, bp=bp, i=i):
            return transformer_block(
                bp, y_, ctx, heads=heads,
                kv2=None if cross_kv is None else cross_kv[i], mode=mode,
                state=sub(state, "transformer_blocks", i))
        y = layers.remat(layer, y) if remat else layer(y)
    y = layers.linear(p["proj_out"], y)
    return y.reshape(n, h, w, c) + residual
