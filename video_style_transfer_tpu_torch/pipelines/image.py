"""UnZipLoRA SDXL image generation pipeline: triple-prompt conditioning
(combined / content / style), CFG, Euler or DPM-Solver++ sampling from
noise, and the VAE decode to uint8. The video path runs the same
functions with its frames as the batch."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from video_style_transfer_tpu_torch.models.vae import vae_decode
from video_style_transfer_tpu_torch.pipelines.sampling import (
    Conditioning, make_cfg_denoiser, sample_dpm, sample_euler)
from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
from video_style_transfer_tpu_torch.schedulers.dpm import dpm_timetable
from video_style_transfer_tpu_torch.schedulers.euler import euler_timetable
from video_style_transfer_tpu_torch.utils.convert import to_device


def default_time_ids(height: int, width: int, batch: int,
                     dtype=torch.float32, device="cpu"):
    """(orig_h, orig_w, crop_top, crop_left, target_h, target_w)."""
    ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=dtype,
                       device=device)
    return ids.repeat(batch, 1)


def draw_noise(shape, generator: Union[torch.Generator,
                                       Sequence[torch.Generator], None],
               device="cpu"):
    """Standard-normal f32 noise of `shape`. A sequence of generators,
    one per row (batched serving of distinct seeds), draws each row with
    shape (1, ...), so a row equals a batch-1 draw from its generator."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for "
                             f"{shape[0]} rows")
        return torch.cat([draw_noise((1,) + tuple(shape[1:]), g, device)
                          for g in generator], dim=0)
    dev = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32, device=dev)


def generate_latents(unet_params, unet_cfg, uncond: Conditioning,
                     cond: Conditioning, *, height: int, width: int,
                     batch: int = 1, num_steps: int = 25,
                     cfg_scale: float = 5.0, guidance_rescale: float = 0.0,
                     sampler: str = "euler", mode: str = "both", state=None,
                     num_frames: int = 1, sched=None, dtype=torch.bfloat16,
                     vae_scale_factor: int = 8, device="cpu",
                     generator=None, noise: Optional[torch.Tensor] = None,
                     on_step=None, frame_shard=None):
    """Denoise from pure noise to clean scaled latents (the reference's
    defaults: 25 steps, CFG 5.0). For video, batch is the B*num_frames
    row count. `generator` is one torch.Generator or one per row; `noise`
    (standard normal, the latent shape) replaces the draw, so a caller
    can feed the same noise to another implementation. frame_shard: see
    make_cfg_denoiser (batch and num_frames are then this rank's)."""
    if sched is None:
        sched = make_schedule()
    shape = (batch, height // vae_scale_factor, width // vae_scale_factor,
             unet_cfg.in_channels)
    if noise is None:
        noise = draw_noise(shape, generator, device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
    noise = noise.to(device=device, dtype=dtype)
    eps_fn = make_cfg_denoiser(unet_params, unet_cfg, uncond, cond,
                               cfg_scale=cfg_scale,
                               guidance_rescale=guidance_rescale, mode=mode,
                               state=state, num_frames=num_frames,
                               dtype=dtype, frame_shard=frame_shard)
    if sampler == "euler":
        table = euler_timetable(sched, num_steps)
        init = torch.tensor(table["init_sigma"],
                            dtype=torch.float32).to(dtype)
        return sample_euler(eps_fn, noise * init.to(device), table,
                            on_step=on_step)
    if sampler == "dpm":
        # VP-scaled tables: sigma_0 ~ 1, the noise is the start
        return sample_dpm(eps_fn, noise, dpm_timetable(sched, num_steps),
                          on_step=on_step)
    raise ValueError(sampler)


def decode_images(vae_params, vae_cfg, latents, *, dtype=torch.float32,
                  check_finite: bool = False):
    """VAE decode -> uint8 (N, H, W, 3) images. fp32 (the default) is the
    reference's decode; bfloat16 is the opt-in fast decode (it keeps
    fp32's exponent range, so the overflow that forces fp32 over fp16
    cannot occur). check_finite raises if the decoder's output holds a
    NaN or an infinity, which the uint8 cast would otherwise hide."""
    if vae_params["post_quant_conv"]["weight"].dtype != dtype:
        vae_params = to_device(vae_params, dtype=dtype)
    imgs = vae_decode(vae_params, vae_cfg, latents.to(dtype)).float()
    if check_finite and not bool(torch.isfinite(imgs).all()):
        raise FloatingPointError("VAE decode produced non-finite pixels")
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return torch.round(imgs * 255.0).to(torch.uint8)


def generate_images(unet_params, unet_cfg, vae_params, vae_cfg,
                    uncond: Conditioning, cond: Conditioning, *,
                    height: int = 1024, width: int = 1024, batch: int = 1,
                    num_steps: int = 25, cfg_scale: float = 5.0,
                    guidance_rescale: float = 0.0, sampler: str = "euler",
                    mode: str = "both", state=None, dtype=torch.bfloat16,
                    vae_scale_factor: int = 8, device="cpu", generator=None,
                    noise=None, decode_dtype=torch.float32,
                    check_finite: bool = False):
    """Text embeddings -> uint8 images."""
    latents = generate_latents(
        unet_params, unet_cfg, uncond, cond, height=height, width=width,
        batch=batch, num_steps=num_steps, cfg_scale=cfg_scale,
        guidance_rescale=guidance_rescale, sampler=sampler, mode=mode,
        state=state, dtype=dtype, vae_scale_factor=vae_scale_factor,
        device=device, generator=generator, noise=noise)
    return decode_images(vae_params, vae_cfg, latents, dtype=decode_dtype,
                         check_finite=check_finite)
