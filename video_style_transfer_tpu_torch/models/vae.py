"""AutoencoderKL (SDXL VAE) — functional, NHWC: the decoder (serving) and
the encoder (training latents). Each mid-block attention (one head,
d = 512, 16384 tokens at 1024^2) takes the flash-attention kernel on
CUDA."""
from __future__ import annotations

import torch

from video_style_transfer_tpu_torch.config import VAEConfig
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.models.attention import (
    attention, init_attention)
from video_style_transfer_tpu_torch.models.resnet import (
    downsample, init_downsample, init_resnet_block, init_upsample,
    resnet_block, upsample)

VAE_EPS = 1e-6  # diffusers AutoencoderKL hard-codes 1e-6 in every norm


def _init_mid(ini, c):
    return {
        "resnets": [init_resnet_block(ini, c, c) for _ in range(2)],
        "attentions": [{"group_norm": layers.init_norm(ini, c),
                        **init_attention(ini, c, heads=1, qkv_bias=True)}],
    }


def _mid(p, x, groups):
    x = resnet_block(p["resnets"][0], x, None, num_groups=groups, eps=VAE_EPS)
    a = p["attentions"][0]
    n, h, w, c = x.shape
    y = layers.group_norm(a["group_norm"], x, num_groups=groups, eps=VAE_EPS)
    y = attention(a, y.reshape(n, h * w, c), None, heads=1)
    x = x + y.reshape(n, h, w, c)
    return resnet_block(p["resnets"][1], x, None, num_groups=groups,
                        eps=VAE_EPS)


def init_vae_decoder(ini, cfg: VAEConfig):
    """Decoder params plus post_quant_conv (the JAX ``init_vae`` tree
    without the encoder side)."""
    rev = list(reversed(cfg.block_out_channels))
    dec = {"conv_in": layers.init_conv(ini, cfg.latent_channels, rev[0], 3),
           "mid_block": _init_mid(ini, rev[0]),
           "up_blocks": []}
    out_c = rev[0]
    for i in range(len(rev)):
        in_c, out_c = out_c, rev[i]
        block = {"resnets": [init_resnet_block(ini, in_c if j == 0 else out_c,
                                               out_c)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["upsamplers"] = [init_upsample(ini, out_c)]
        dec["up_blocks"].append(block)
    dec["conv_norm_out"] = layers.init_norm(ini, rev[-1])
    dec["conv_out"] = layers.init_conv(ini, rev[-1], cfg.out_channels, 3)
    return {"decoder": dec,
            "post_quant_conv": layers.init_conv(ini, cfg.latent_channels,
                                                cfg.latent_channels, 1)}


def init_vae_encoder(ini, cfg: VAEConfig):
    """Encoder params plus quant_conv (the JAX ``init_vae`` tree without
    the decoder side)."""
    ch = cfg.block_out_channels
    enc = {"conv_in": layers.init_conv(ini, cfg.in_channels, ch[0], 3),
           "down_blocks": []}
    out_c = ch[0]
    for i in range(len(ch)):
        in_c, out_c = out_c, ch[i]
        block = {"resnets": [init_resnet_block(ini, in_c if j == 0 else out_c,
                                               out_c)
                             for j in range(cfg.layers_per_block)]}
        if i < len(ch) - 1:
            block["downsamplers"] = [init_downsample(ini, out_c)]
        enc["down_blocks"].append(block)
    enc["mid_block"] = _init_mid(ini, ch[-1])
    enc["conv_norm_out"] = layers.init_norm(ini, ch[-1])
    enc["conv_out"] = layers.init_conv(ini, ch[-1], 2 * cfg.latent_channels,
                                       3)
    return {"encoder": enc,
            "quant_conv": layers.init_conv(ini, 2 * cfg.latent_channels,
                                           2 * cfg.latent_channels, 1)}


def vae_encode_moments(params, cfg: VAEConfig, x):
    """x: (N, H, W, 3) in [-1, 1] -> (mean, logvar), each
    (N, H/8, W/8, latent); logvar clipped to [-30, 20]."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    h = layers.conv2d(enc["conv_in"], x)
    for block in enc["down_blocks"]:
        for rp in block["resnets"]:
            h = resnet_block(rp, h, None, num_groups=g, eps=VAE_EPS)
        if "downsamplers" in block:
            h = downsample(block["downsamplers"][0], h)
    h = _mid(enc["mid_block"], h, g)
    h = layers.group_norm(enc["conv_norm_out"], h, num_groups=g, eps=VAE_EPS,
                          silu=True)
    moments = layers.conv2d(params["quant_conv"],
                            layers.conv2d(enc["conv_out"], h))
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_encode(params, cfg: VAEConfig, x, eps=None):
    """Scaled latents: the posterior mean plus, when `eps` (a standard
    normal draw of the latent shape) is given, std * eps."""
    mean, logvar = vae_encode_moments(params, cfg, x)
    if eps is not None:
        mean = mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
    return mean * cfg.scaling_factor


def vae_decode(params, cfg: VAEConfig, z):
    """z: (N, h, w, latent) scaled latents -> (N, 8h, 8w, 3)."""
    g = cfg.norm_num_groups
    dec = params["decoder"]
    h = layers.conv2d(params["post_quant_conv"], z / cfg.scaling_factor)
    h = layers.conv2d(dec["conv_in"], h)
    h = _mid(dec["mid_block"], h, g)
    for block in dec["up_blocks"]:
        for rp in block["resnets"]:
            h = resnet_block(rp, h, None, num_groups=g, eps=VAE_EPS)
        if "upsamplers" in block:
            h = upsample(block["upsamplers"][0], h)
    h = layers.group_norm(dec["conv_norm_out"], h, num_groups=g, eps=VAE_EPS,
                          silu=True)
    return layers.conv2d(dec["conv_out"], h)
