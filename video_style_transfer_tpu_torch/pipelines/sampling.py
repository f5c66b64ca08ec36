"""Denoise loops with batched classifier-free guidance. The JAX package's
``lax.scan`` over steps becomes a Python loop."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from video_style_transfer_tpu_torch.models.unet import (
    precompute_cross_kv, unet_apply)
from video_style_transfer_tpu_torch.schedulers.dpm import (
    dpm_init_carry, dpm_step, to_x0)
from video_style_transfer_tpu_torch.schedulers.euler import (
    euler_step, scale_model_input)


class Conditioning(NamedTuple):
    """One side of the CFG pair."""
    ctx: Tuple           # (combined, content, style) prompt embeddings
    pooled: torch.Tensor
    time_ids: torch.Tensor


def tile_conditioning(c: Conditioning, n: int) -> Conditioning:
    """Repeat a batch-1 Conditioning to n serving rows (the same prompt
    set conditions every sample of a batch)."""
    def rep(x):
        return None if x is None else x.repeat((n,) + (1,) * (x.dim() - 1))

    return Conditioning(ctx=tuple(rep(e) for e in c.ctx),
                        pooled=rep(c.pooled), time_ids=rep(c.time_ids))


def _cat_cond(uncond: Conditioning, cond: Conditioning) -> Conditioning:
    def cat_ctx(i):
        a, b = uncond.ctx[i], cond.ctx[i]
        if a is None and b is None:
            return None
        # a missing stream falls back to that side's combined prompt
        a = uncond.ctx[0] if a is None else a
        b = cond.ctx[0] if b is None else b
        return torch.cat([a, b], dim=0)

    return Conditioning(
        ctx=tuple(cat_ctx(i) for i in range(len(uncond.ctx))),
        pooled=torch.cat([uncond.pooled, cond.pooled], dim=0),
        time_ids=torch.cat([uncond.time_ids, cond.time_ids], dim=0))


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale: float):
    """CFG rescale ("Common Diffusion Noise Schedules are Flawed", 3.4):
    match the CFG prediction's per-sample standard deviation to the
    text prediction's, blended by guidance_rescale."""
    axes = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=axes, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=axes, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return (guidance_rescale * rescaled
            + (1.0 - guidance_rescale) * noise_cfg)


def make_cfg_denoiser(unet_params, unet_cfg, uncond: Conditioning,
                      cond: Conditioning, *, cfg_scale: float,
                      guidance_rescale: float = 0.0, mode: str = "both",
                      state=None, num_frames: int = 1,
                      dtype=None, frame_shard=None) -> Callable:
    """Returns eps_fn(latents, t) with the CFG pair batched as a doubled
    leading axis ([uncond, cond]). Every cross-attention's prompt k/v,
    live LoRA branches included, is evaluated once here (it is invariant
    across steps); `dtype` casts the prompt embeddings before
    projecting. frame_shard: the latents are this rank's num_frames
    frames of a frame-parallel clip (unet_apply's); both CFG rows of
    them are local, so the combine needs no collective."""
    both = _cat_cond(uncond, cond)
    kv = precompute_cross_kv(unet_params, unet_cfg, both.ctx, mode=mode,
                             state=state, dtype=dtype,
                             num_frames=num_frames)

    def eps_fn(latents, t):
        doubled = torch.cat([latents, latents], dim=0)
        out = unet_apply(unet_params, unet_cfg, doubled, t, both.ctx,
                         both.pooled, both.time_ids, mode=mode, state=state,
                         num_frames=num_frames, cross_kv=kv,
                         frame_shard=frame_shard)
        eps_u, eps_c = out.chunk(2, dim=0)
        eps = eps_u + cfg_scale * (eps_c - eps_u)
        if guidance_rescale > 0.0:
            eps = rescale_noise_cfg(eps, eps_c, guidance_rescale)
        return eps

    return eps_fn


def _timestep(t, device):
    return torch.tensor(float(t), dtype=torch.float32, device=device)


def sample_euler(eps_fn, latents, table, *,
                 on_step: Optional[Callable[[int], None]] = None):
    """Run the Euler schedule; `latents` are already scaled by
    table["init_sigma"]. on_step(i) is called after step i."""
    sigmas, timesteps = table["sigmas"], table["timesteps"]
    for i in range(len(timesteps)):
        model_in = scale_model_input(latents, sigmas[i])
        eps = eps_fn(model_in, _timestep(timesteps[i], latents.device))
        latents = euler_step(latents, eps, sigmas[i], sigmas[i + 1])
        if on_step is not None:
            on_step(i)
    return latents


def sample_dpm(eps_fn, latents, table, *,
               on_step: Optional[Callable[[int], None]] = None):
    """Run DPM-Solver++ 2M; `latents` are plain noise (the tables are
    VP-scaled: sigma_0 ~ 1). on_step(i) is called after step i."""
    timesteps = table["timesteps"]
    carry = dpm_init_carry(latents.shape, latents.device)
    for i in range(len(timesteps)):
        eps = eps_fn(latents, _timestep(timesteps[i], latents.device))
        x0 = to_x0(latents, eps, table["alpha"][i], table["sigma"][i])
        latents, carry = dpm_step(latents, x0, carry, i, table)
        if on_step is not None:
            on_step(i)
    return latents
