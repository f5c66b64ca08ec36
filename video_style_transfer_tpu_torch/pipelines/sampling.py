"""Denoise loops with batched classifier-free guidance. The JAX package's
``lax.scan`` over steps becomes a Python loop."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from video_style_transfer_tpu_torch.models.unet import (
    precompute_cross_kv, unet_apply)
from video_style_transfer_tpu_torch.schedulers.euler import (
    euler_step, scale_model_input)


class Conditioning(NamedTuple):
    """One side of the CFG pair."""
    ctx: Tuple           # (combined, content, style) prompt embeddings
    pooled: torch.Tensor
    time_ids: torch.Tensor


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


def make_cfg_denoiser(unet_params, unet_cfg, uncond: Conditioning,
                      cond: Conditioning, *, cfg_scale: float,
                      num_frames: int = 1, dtype=None) -> Callable:
    """Returns eps_fn(latents, t) with the CFG pair batched as a doubled
    leading axis ([uncond, cond]). Every cross-attention's prompt k/v is
    evaluated once here (it is invariant across steps); `dtype` casts the
    prompt embeddings before projecting."""
    both = _cat_cond(uncond, cond)
    kv = precompute_cross_kv(unet_params, unet_cfg, both.ctx, dtype=dtype,
                             num_frames=num_frames)

    def eps_fn(latents, t):
        doubled = torch.cat([latents, latents], dim=0)
        out = unet_apply(unet_params, unet_cfg, doubled, t, both.ctx,
                         both.pooled, both.time_ids, num_frames=num_frames,
                         cross_kv=kv)
        eps_u, eps_c = out.chunk(2, dim=0)
        return eps_u + cfg_scale * (eps_c - eps_u)

    return eps_fn


def sample_euler(eps_fn, latents, table, *,
                 on_step: Optional[Callable[[int], None]] = None):
    """Run the Euler schedule; `latents` are already scaled by
    table["init_sigma"]. on_step(i) is called after step i."""
    sigmas, timesteps = table["sigmas"], table["timesteps"]
    for i in range(len(timesteps)):
        model_in = scale_model_input(latents, sigmas[i])
        t = torch.tensor(float(timesteps[i]), dtype=torch.float32,
                         device=latents.device)
        eps = eps_fn(model_in, t)
        latents = euler_step(latents, eps, sigmas[i], sigmas[i + 1])
        if on_step is not None:
            on_step(i)
    return latents
