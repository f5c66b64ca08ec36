"""AnimateDiff-XL video generation: motion-UNet Euler denoise over the
(F, h, w, 4) latents of one video with the CFG pair batched, in any of
the UnZipLoRA modes, then a per-frame VAE decode."""
from __future__ import annotations

import torch

from video_style_transfer_tpu_torch.pipelines.image import (
    decode_images, generate_latents)
from video_style_transfer_tpu_torch.pipelines.sampling import Conditioning
from video_style_transfer_tpu_torch.utils.convert import to_device


def generate_video_latents(unet_params, unet_cfg, uncond: Conditioning,
                           cond: Conditioning, *, num_frames: int = 16,
                           height: int = 1024, width: int = 1024,
                           num_steps: int = 30, cfg_scale: float = 7.5,
                           mode: str = "both", state=None,
                           dtype=torch.bfloat16,
                           sched=None, vae_scale_factor: int = 8,
                           device="cpu", generator=None, noise=None,
                           on_step=None):
    """(num_frames, h/8, w/8, 4) scaled latents for one video; the
    conditioning batch is 1 and is broadcast across frames in the UNet.
    The loop runs one step per UNet call, so a long video needs no
    chunked variant."""
    return generate_latents(
        unet_params, unet_cfg, uncond, cond, height=height, width=width,
        batch=num_frames, num_steps=num_steps, cfg_scale=cfg_scale,
        sampler="euler", mode=mode, state=state, num_frames=num_frames,
        dtype=dtype, sched=sched, vae_scale_factor=vae_scale_factor,
        device=device, generator=generator, noise=noise, on_step=on_step)


def decode_video(vae_params, vae_cfg, latents, *, chunk: int = 1,
                 dtype=torch.float32, check_finite: bool = False):
    """Per-frame (chunk frames at a time) VAE decode -> (F, H, W, 3)
    uint8, as the reference decodes frame by frame in fp32. Another
    `dtype` casts the VAE once, before the loop."""
    if vae_params["post_quant_conv"]["weight"].dtype != dtype:
        vae_params = to_device(vae_params, dtype=dtype)
    frames = [decode_images(vae_params, vae_cfg, latents[i:i + chunk],
                            dtype=dtype, check_finite=check_finite)
              for i in range(0, latents.shape[0], max(chunk, 1))]
    return torch.cat(frames, dim=0)


def generate_video(unet_params, unet_cfg, vae_params, vae_cfg,
                   uncond: Conditioning, cond: Conditioning, *,
                   num_frames: int = 16, height: int = 1024,
                   width: int = 1024, num_steps: int = 30,
                   cfg_scale: float = 7.5, mode: str = "both", state=None,
                   dtype=torch.bfloat16,
                   decode_chunk: int = 1, vae_scale_factor: int = 8,
                   device="cpu", generator=None, noise=None,
                   decode_dtype=torch.float32,
                   check_finite: bool = False):
    """Full video program: returns (F, H, W, 3) uint8 frames."""
    latents = generate_video_latents(
        unet_params, unet_cfg, uncond, cond, num_frames=num_frames,
        height=height, width=width, num_steps=num_steps,
        cfg_scale=cfg_scale, mode=mode, state=state, dtype=dtype,
        vae_scale_factor=vae_scale_factor, device=device,
        generator=generator, noise=noise)
    return decode_video(vae_params, vae_cfg, latents, chunk=decode_chunk,
                        dtype=decode_dtype, check_finite=check_finite)
