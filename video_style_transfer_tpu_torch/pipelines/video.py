"""AnimateDiff-XL video generation: motion-UNet Euler denoise over the
(F, h, w, 4) latents of one video with the CFG pair batched, in any of
the UnZipLoRA modes, then a per-frame VAE decode.

Frame-parallel serving (a ``parallel.mesh.FrameShard``): every rank draws
the initial latents of all F frames from the seed and keeps its own
contiguous run, with both CFG rows of it, so the sampler's CFG combine
and Euler update stay local; only the motion modules exchange frames.
Each rank decodes its own frames (``decode_video_frame_sharded``) and
the frames are gathered."""
from __future__ import annotations

import torch

from video_style_transfer_tpu_torch.pipelines.image import (
    decode_images, draw_noise, generate_latents)
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
                           on_step=None, frame_shard=None):
    """(num_frames, h/8, w/8, 4) scaled latents for one video; the
    conditioning batch is 1 and is broadcast across frames in the UNet.
    The loop runs one step per UNet call, so a long video needs no
    chunked variant. Under `frame_shard` the noise of all num_frames
    frames is drawn and this rank's frames (frame_shard.slice()) are
    denoised and returned."""
    batch = num_frames
    if frame_shard is not None:
        if frame_shard.frames != num_frames:
            raise ValueError(f"a shard of {frame_shard.frames} frames for "
                             f"a {num_frames}-frame video")
        if noise is None:
            noise = draw_noise((num_frames, height // vae_scale_factor,
                                width // vae_scale_factor,
                                unet_cfg.in_channels), generator, device)
        noise, batch = noise[frame_shard.slice()], frame_shard.local
    return generate_latents(
        unet_params, unet_cfg, uncond, cond, height=height, width=width,
        batch=batch, num_steps=num_steps, cfg_scale=cfg_scale,
        sampler="euler", mode=mode, state=state, num_frames=batch,
        dtype=dtype, sched=sched, vae_scale_factor=vae_scale_factor,
        device=device, generator=generator, noise=noise, on_step=on_step,
        frame_shard=frame_shard)


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


def decode_video_frame_sharded(vae_params, vae_cfg, latents, frame_shard, *,
                               dtype=torch.float32,
                               check_finite: bool = False):
    """Frame-parallel decode: this rank's latents (frame_shard.local
    frames) decoded one frame a call, then every rank's frames gathered
    in order -> (F, H, W, 3) uint8 on every rank. The exchange pads each
    rank's frames to the longest run, as the JAX package pads F to a
    multiple of the frame axis; the padding is dropped."""
    from video_style_transfer_tpu_torch.parallel.distributed import (
        gather_rows)
    mine = decode_video(vae_params, vae_cfg, latents, chunk=1, dtype=dtype,
                        check_finite=check_finite)
    return gather_rows(mine, frame_shard.counts, frame_shard.group)


def generate_video(unet_params, unet_cfg, vae_params, vae_cfg,
                   uncond: Conditioning, cond: Conditioning, *,
                   num_frames: int = 16, height: int = 1024,
                   width: int = 1024, num_steps: int = 30,
                   cfg_scale: float = 7.5, mode: str = "both", state=None,
                   dtype=torch.bfloat16,
                   decode_chunk: int = 1, vae_scale_factor: int = 8,
                   device="cpu", generator=None, noise=None,
                   decode_dtype=torch.float32,
                   check_finite: bool = False, frame_shard=None):
    """Full video program: returns (F, H, W, 3) uint8 frames (on every
    rank of a frame-parallel run)."""
    latents = generate_video_latents(
        unet_params, unet_cfg, uncond, cond, num_frames=num_frames,
        height=height, width=width, num_steps=num_steps,
        cfg_scale=cfg_scale, mode=mode, state=state, dtype=dtype,
        vae_scale_factor=vae_scale_factor, device=device,
        generator=generator, noise=noise, frame_shard=frame_shard)
    if frame_shard is not None:
        return decode_video_frame_sharded(
            vae_params, vae_cfg, latents, frame_shard, dtype=decode_dtype,
            check_finite=check_finite)
    return decode_video(vae_params, vae_cfg, latents, chunk=decode_chunk,
                        dtype=decode_dtype, check_finite=check_finite)
