"""Shared CLI runtime: device selection, model assembly with seeded
random weights, text conditioning and VAE-encoded training latents.

Checkpoint loading and the CLIP tokenizer are not ported yet, so every
model is built from a seed and every prompt becomes seeded token ids
(stable across processes: derived from a CRC of the text), which then
run through the real CLIP encoders. ``smoke`` selects the tiny configs.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from video_style_transfer_tpu_torch.config import (
    CLIPConfig, UNetConfig, VAEConfig)
from video_style_transfer_tpu_torch.models.clip import (
    encode_sdxl_prompt, init_clip)
from video_style_transfer_tpu_torch.models.layers import Init
from video_style_transfer_tpu_torch.models.unet import init_unet
from video_style_transfer_tpu_torch.models.vae import (
    init_vae_decoder, init_vae_encoder, vae_encode)
from video_style_transfer_tpu_torch.pipelines.image import default_time_ids
from video_style_transfer_tpu_torch.pipelines.sampling import Conditioning

DEFAULT_NEGATIVE_PROMPT = (
    "watermark, lowres, low quality, blur, out of focus, grainy, "
    "jpeg artifacts, cropped, poorly lit, duplicate")


@dataclass
class ModelBundle:
    unet: Any
    unet_cfg: UNetConfig
    vae: Any
    vae_cfg: VAEConfig
    clip_l: Any
    clip_l_cfg: CLIPConfig
    clip_g: Any
    clip_g_cfg: CLIPConfig
    device: torch.device
    vae_scale_factor: int = 8
    vae_encoder: Any = None


def resolve_device(name: str) -> torch.device:
    """The requested device; asking for CUDA without a usable card is an
    error, never a silent move to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available here "
                         f"(pass --device cpu to run the plain versions)")
    return dev


def model_configs(smoke: bool, motion: bool):
    """(UNet, VAE, CLIP-L, CLIP-bigG) configs. The tiny set is
    self-consistent: CLIP hidden sizes sum to the UNet's
    cross_attention_dim and bigG's projection fills its pooled slot."""
    if smoke:
        return (UNetConfig.tiny(use_motion_modules=motion), VAEConfig.tiny(),
                CLIPConfig.tiny(), CLIPConfig.tiny(projection_dim=32))
    return (UNetConfig.sdxl(use_motion_modules=motion), VAEConfig.sdxl(),
            CLIPConfig.sdxl_clip_l(), CLIPConfig.sdxl_big_g())


def load_models(pretrained: Optional[str], *, smoke: bool = False,
                motion: bool = True, dtype=torch.bfloat16, seed: int = 0,
                device="cpu", encoder: bool = False) -> ModelBundle:
    """UNet and CLIPs in `dtype`, the VAE decoder (and with `encoder` the
    VAE encoder) in fp32 (the reference keeps the VAE in fp32), all drawn
    from `seed` on `device`."""
    if pretrained:
        raise SystemExit("loading checkpoints is not ported yet: run "
                         "without --pretrained_model_name_or_path for "
                         "seeded random weights")
    device = torch.device(device)
    ucfg, vcfg, lcfg, gcfg = model_configs(smoke, motion)
    return ModelBundle(
        unet=init_unet(Init(seed, device, dtype), ucfg), unet_cfg=ucfg,
        vae=init_vae_decoder(Init(seed + 1, device), vcfg),
        vae_cfg=vcfg,
        clip_l=init_clip(Init(seed + 2, device, dtype), lcfg),
        clip_l_cfg=lcfg,
        clip_g=init_clip(Init(seed + 3, device, dtype), gcfg),
        clip_g_cfg=gcfg, device=device,
        vae_scale_factor=2 ** (len(vcfg.block_out_channels) - 1),
        vae_encoder=(init_vae_encoder(Init(seed + 4, device), vcfg)
                     if encoder else None))


def prompt_token_ids(prompt: str, cfg: CLIPConfig, *, pad_with_eos: bool):
    """Seeded stand-in for the CLIP tokenizer: BOS (vocab-2), one random
    id per word, EOS (vocab-1), then padding (EOS for CLIP-L, 0 for bigG,
    as SDXL's two tokenizers pad). Returns (1, max_position_embeddings)
    int64 numpy."""
    length = cfg.max_position_embeddings
    bos, eos = cfg.vocab_size - 2, cfg.vocab_size - 1
    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    n = min(max(len(prompt.split()), 1), length - 2)
    ids = np.full((1, length), eos if pad_with_eos else 0, np.int64)
    ids[0, 0] = bos
    ids[0, 1:n + 1] = rng.integers(0, cfg.vocab_size - 2, n)
    ids[0, n + 1] = eos
    return ids


def encode_prompt(bundle: ModelBundle, prompt: str):
    """(embeds (1, 77, 2048), pooled (1, proj)) through both encoders."""
    dev = bundle.device
    ids_l = torch.from_numpy(prompt_token_ids(
        prompt, bundle.clip_l_cfg, pad_with_eos=True)).to(dev)
    ids_g = torch.from_numpy(prompt_token_ids(
        prompt, bundle.clip_g_cfg, pad_with_eos=False)).to(dev)
    return encode_sdxl_prompt(bundle.clip_l, bundle.clip_l_cfg,
                              bundle.clip_g, bundle.clip_g_cfg, ids_l, ids_g,
                              eos_l=bundle.clip_l_cfg.vocab_size - 1,
                              eos_g=bundle.clip_g_cfg.vocab_size - 1)


def make_conditioning(bundle: ModelBundle, prompt: str, *, height: int,
                      width: int) -> Conditioning:
    emb, pooled = encode_prompt(bundle, prompt)
    return Conditioning(ctx=(emb, None, None), pooled=pooled,
                        time_ids=default_time_ids(height, width, 1,
                                                  device=bundle.device))


def negative_conditioning(bundle: ModelBundle, negative_prompt: str, *,
                          height: int, width: int) -> Conditioning:
    """Unconditional side of the CFG pair (every stream shares the
    negative prompt)."""
    emb, pooled = encode_prompt(bundle, negative_prompt)
    return Conditioning(ctx=(emb, emb, emb), pooled=pooled,
                        time_ids=default_time_ids(height, width, 1,
                                                  device=bundle.device))


def encode_latents(bundle: ModelBundle, images, generator: torch.Generator):
    """(N, H, W, 3) in [-1, 1] -> scaled latents (N, H/f, W/f, 4), each a
    draw mean + std * eps of the posterior: fp32 encode one frame per call
    (a whole 8-frame 1024^2 clip at once holds far more activation
    memory)."""
    out = []
    for k in range(images.shape[0]):
        x = images[k:k + 1].float()
        eps = torch.randn((1, x.shape[1] // bundle.vae_scale_factor,
                           x.shape[2] // bundle.vae_scale_factor,
                           bundle.vae_cfg.latent_channels),
                          generator=generator, device=x.device)
        out.append(vae_encode(bundle.vae_encoder, bundle.vae_cfg, x, eps))
    return torch.cat(out)
