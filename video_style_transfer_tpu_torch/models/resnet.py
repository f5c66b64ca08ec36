"""ResNet blocks and resampling layers for the UNet / VAE (NHWC)."""
from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from video_style_transfer_tpu_torch.models import layers


def init_resnet_block(ini, in_channels: int, out_channels: int, *,
                      temb_channels: Optional[int] = None):
    p = {
        "norm1": layers.init_norm(ini, in_channels),
        "conv1": layers.init_conv(ini, in_channels, out_channels, 3),
        "norm2": layers.init_norm(ini, out_channels),
        "conv2": layers.init_conv(ini, out_channels, out_channels, 3),
    }
    if temb_channels is not None:
        p["time_emb_proj"] = layers.init_linear(ini, temb_channels,
                                                out_channels)
    if in_channels != out_channels:
        p["conv_shortcut"] = layers.init_conv(ini, in_channels, out_channels,
                                              1)
    return p


def resnet_block(p, x, temb=None, *, num_groups: int, eps: float = 1e-5):
    """x: (N, H, W, C); temb: (N, temb_channels) or None."""
    h = layers.group_norm(p["norm1"], x, num_groups=num_groups, eps=eps,
                          silu=True)
    h = layers.conv2d(p["conv1"], h)
    if temb is not None and "time_emb_proj" in p:
        t = layers.linear(p["time_emb_proj"], layers.silu(temb))
        h = h + t[:, None, None, :].to(h.dtype)
    h = layers.group_norm(p["norm2"], h, num_groups=num_groups, eps=eps,
                          silu=True)
    h = layers.conv2d(p["conv2"], h)
    if "conv_shortcut" in p:
        x = layers.conv2d(p["conv_shortcut"], x)
    return x + h


def init_downsample(ini, channels: int):
    return {"conv": layers.init_conv(ini, channels, channels, 3)}


def downsample(p, x):
    """Stride-2 conv with diffusers' asymmetric (0, 1) padding."""
    x = F.pad(x, (0, 0, 0, 1, 0, 1))
    return layers.conv2d(p["conv"], x, stride=2, padding="VALID")


def init_upsample(ini, channels: int, out_channels: Optional[int] = None):
    return {"conv": layers.init_conv(ini, channels, out_channels or channels,
                                     3)}


def upsample(p, x):
    """Nearest-neighbour 2x, then a 3x3 conv."""
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return layers.conv2d(p["conv"], y.reshape(n, h * 2, w * 2, c))
