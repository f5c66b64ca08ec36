"""Timestep / conditioning embeddings for the SDXL UNet (diffusers
Timesteps + TimestepEmbedding and the SDXL "text_time" added
conditioning)."""
from __future__ import annotations

import math

import torch

from video_style_transfer_tpu_torch.models import layers


def sinusoidal_embedding(timesteps, dim: int, *, flip_sin_to_cos: bool = True,
                         freq_shift: float = 0.0,
                         max_period: float = 10000.0):
    """get_timestep_embedding semantics. timesteps: (...,) -> (..., dim)
    float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - freq_shift))
    args = timesteps.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def init_timestep_embedding(ini, in_dim: int, embed_dim: int):
    return {"linear_1": layers.init_linear(ini, in_dim, embed_dim),
            "linear_2": layers.init_linear(ini, embed_dim, embed_dim)}


def timestep_embedding(p, emb):
    emb = layers.silu(layers.linear(p["linear_1"], emb))
    return layers.linear(p["linear_2"], emb)


def sdxl_add_embedding(p, text_embeds, time_ids, *, addition_time_embed_dim,
                       flip_sin_to_cos=True, freq_shift=0.0):
    """Fourier-embed each of the 6 time_ids, concat with the pooled text
    embedding, run the TimestepEmbedding MLP."""
    b = time_ids.shape[0]
    time_embeds = sinusoidal_embedding(
        time_ids.reshape(-1), addition_time_embed_dim,
        flip_sin_to_cos=flip_sin_to_cos, freq_shift=freq_shift)
    time_embeds = time_embeds.reshape(b, -1)
    add = torch.cat([text_embeds.to(time_embeds.dtype), time_embeds], dim=-1)
    return timestep_embedding(p, add)


def temporal_positional_encoding(num_frames: int, dim: int, max_len: int = 32,
                                 device="cpu"):
    """Sinusoidal frame-position encoding, (F, dim) float32."""
    if num_frames > max_len:
        raise ValueError(
            f"num_frames={num_frames} exceeds the motion modules' "
            f"positional-encoding cap max_seq_length={max_len}")
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                      device=device)
                         * (-math.log(10000.0) / dim))
    args = position * div_term
    pe = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(args)
    pe[:, 1::2] = torch.cos(args)[:, : dim // 2]
    return pe[:num_frames]
