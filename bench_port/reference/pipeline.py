"""Plain reference of what the serving paths compute around the models:
the seeded stand-in tokenizer, SDXL's conditioning, the Euler discrete
schedule (diffusers' "leading" spacing, steps_offset 1), classifier-free
guidance, the starting noise and the uint8 quantisation of decoded
pixels. Written from the published algorithms; imports nothing of the
program."""
from __future__ import annotations

import zlib

import numpy as np
import torch

from bench_port.reference import models


def token_ids(prompt: str, cfg: dict, pad_with_eos: bool):
    """BOS (vocab-2), one id a word drawn from a CRC of the text, EOS
    (vocab-1), then padding (EOS for CLIP-L, 0 for bigG): SDXL's two
    tokenizers' layout without a vocabulary. (1, 77) int64."""
    length = cfg["max_position_embeddings"]
    bos, eos = cfg["vocab_size"] - 2, cfg["vocab_size"] - 1
    rng = np.random.default_rng(zlib.crc32(prompt.encode()))
    n = min(max(len(prompt.split()), 1), length - 2)
    ids = np.full((1, length), eos if pad_with_eos else 0, np.int64)
    ids[0, 0] = bos
    ids[0, 1:n + 1] = rng.integers(0, cfg["vocab_size"] - 2, n)
    ids[0, n + 1] = eos
    return torch.from_numpy(ids)


def encode(weights, cfg, prompt: str, device, nx=models.FP32):
    """(embeds (1, 77, 2048), pooled (1, 1280)) float32."""
    ids_l = token_ids(prompt, cfg["clip_l"], True).to(device)
    ids_g = token_ids(prompt, cfg["clip_g"], False).to(device)
    return models.encode_prompt(weights["clip_l"], cfg["clip_l"],
                                weights["clip_g"], cfg["clip_g"], ids_l,
                                ids_g, nx)


def time_ids(height: int, width: int, device):
    return torch.tensor([[height, width, 0, 0, height, width]],
                        dtype=torch.float32, device=device)


def scaled_linear_alphas_cumprod(steps=1000, beta_start=0.00085,
                                 beta_end=0.012):
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, steps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def euler_table(num_steps: int, train_steps: int = 1000):
    """timesteps (steps,), sigmas (steps + 1,) ending in 0, and the
    initial noise scale, as float32 values."""
    acp = scaled_linear_alphas_cumprod(train_steps).astype(np.float64)
    full = np.sqrt((1 - acp) / acp)
    ratio = train_steps // num_steps
    ts = (np.arange(num_steps) * ratio).round()[::-1] + 1.0
    sig = np.concatenate([np.interp(ts, np.arange(train_steps), full), [0]])
    init = float(np.float32((sig.max() ** 2 + 1) ** 0.5))
    return ts.astype(np.float32), sig.astype(np.float32), init


def start_latents(noise_seeds, shape, device, dtype, init_sigma: float):
    """Standard-normal noise, one CPU generator a row (a single seed
    draws all rows at once), in the serving dtype, times the initial
    sigma in that dtype."""
    if len(noise_seeds) == 1:
        g = torch.Generator().manual_seed(noise_seeds[0])
        noise = torch.randn(tuple(shape), generator=g, dtype=torch.float32)
    else:
        noise = torch.cat([
            torch.randn((1,) + tuple(shape[1:]),
                        generator=torch.Generator().manual_seed(s),
                        dtype=torch.float32) for s in noise_seeds])
    init = torch.tensor(init_sigma, dtype=torch.float32).to(dtype)
    return noise.to(device=device, dtype=dtype) * init.to(device)


def euler_step(sample, eps, sigma: float, sigma_next: float):
    """x + (x - (x - sigma eps)) / sigma * (sigma_next - sigma) in
    float32, rounded once to the sample's dtype."""
    sigma, sigma_next = float(sigma), float(sigma_next)
    x = sample.float()
    denoised = x - sigma * eps.float()
    derivative = (x - denoised) / sigma
    return (x + derivative * (sigma_next - sigma)).to(sample.dtype)


def cfg_eps(weights, cfg, cond, uncond, latents, t, sigma: float, *,
            scale: float, frames: int, mode: str, state, nx=models.FP32):
    """The guided eps at the (unscaled) latents: the UNet on both halves
    of the CFG pair at latents / sqrt(sigma^2 + 1), then
    eps_u + scale (eps_c - eps_u). cond / uncond: (ctx triple, pooled,
    time_ids), one row each per clip."""
    x = latents.float() / float(np.sqrt(np.float32(sigma) ** 2 + 1))
    ctx = tuple(None if (a is None and b is None) else
                torch.cat([uncond[0][0] if a is None else a,
                           cond[0][0] if b is None else b])
                for a, b in zip(uncond[0], cond[0]))
    out = models.unet(weights["unet"], cfg["unet"], torch.cat([x, x]),
                      float(t), ctx, torch.cat([uncond[1], cond[1]]),
                      torch.cat([uncond[2], cond[2]]), frames=frames,
                      mode=mode, state=state, nx=nx)
    eps_u, eps_c = out.chunk(2)
    return eps_u + scale * (eps_c - eps_u)


def to_uint8(pixels):
    """Decoded pixels in [-1, 1] -> uint8, round half to even."""
    return torch.round(torch.clamp(pixels.float() / 2 + 0.5, 0.0, 1.0)
                       * 255.0).to(torch.uint8)
