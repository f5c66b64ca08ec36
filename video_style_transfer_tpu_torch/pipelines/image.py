"""The parts of the SDXL image pipeline the video path shares: SDXL
micro-conditioning ids, the Euler denoise from noise, and the VAE decode
to uint8."""
from __future__ import annotations

from typing import Optional

import torch

from video_style_transfer_tpu_torch.models.vae import vae_decode
from video_style_transfer_tpu_torch.pipelines.sampling import (
    Conditioning, make_cfg_denoiser, sample_euler)
from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
from video_style_transfer_tpu_torch.schedulers.euler import euler_timetable


def default_time_ids(height: int, width: int, batch: int,
                     dtype=torch.float32, device="cpu"):
    """(orig_h, orig_w, crop_top, crop_left, target_h, target_w)."""
    ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=dtype,
                       device=device)
    return ids.repeat(batch, 1)


def generate_latents(unet_params, unet_cfg, uncond: Conditioning,
                     cond: Conditioning, *, height: int, width: int,
                     batch: int = 1, num_steps: int = 25,
                     cfg_scale: float = 5.0, num_frames: int = 1,
                     sched=None, dtype=torch.bfloat16,
                     vae_scale_factor: int = 8, device="cpu",
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, on_step=None):
    """Euler denoise from pure noise to clean scaled latents. For video,
    batch is the B*num_frames row count. `noise` (standard normal, the
    latent shape) replaces the draw from `generator`, so a caller can feed
    the same noise to another implementation."""
    if sched is None:
        sched = make_schedule()
    shape = (batch, height // vae_scale_factor, width // vae_scale_factor,
             unet_cfg.in_channels)
    if noise is None:
        noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device if generator is not None
                            else device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
    noise = noise.to(device=device, dtype=dtype)
    eps_fn = make_cfg_denoiser(unet_params, unet_cfg, uncond, cond,
                               cfg_scale=cfg_scale, num_frames=num_frames,
                               dtype=dtype)
    table = euler_timetable(sched, num_steps)
    init = torch.tensor(table["init_sigma"], dtype=torch.float32).to(dtype)
    return sample_euler(eps_fn, noise * init.to(device), table,
                        on_step=on_step)


def decode_images(vae_params, vae_cfg, latents, *,
                  check_finite: bool = False):
    """VAE decode -> uint8 (N, H, W, 3) images, in the VAE params' dtype
    (fp32, as the reference decodes). check_finite raises if the
    decoder's output holds a NaN or an infinity, which the uint8 cast
    would otherwise hide."""
    dtype = vae_params["post_quant_conv"]["weight"].dtype
    imgs = vae_decode(vae_params, vae_cfg, latents.to(dtype)).float()
    if check_finite and not bool(torch.isfinite(imgs).all()):
        raise FloatingPointError("VAE decode produced non-finite pixels")
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return torch.round(imgs * 255.0).to(torch.uint8)
