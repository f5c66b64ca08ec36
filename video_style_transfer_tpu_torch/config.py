"""Model configuration dataclasses (counterpart of the JAX package's
config.py, which imports JAX; the LoRA configs come with the LoRA slice).
Every model config ships an ``sdxl()`` (production) and a ``tiny()``
(test) constructor with the same values as the reference."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

DOWN = "down"
CROSS = "crossattn"
UP = "up"


@dataclass(frozen=True)
class UNetConfig:
    """SDXL UNet2DCondition topology, optionally with AnimateDiff motion
    modules after each attention group."""

    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (DOWN, CROSS, CROSS)
    up_block_types: Tuple[str, ...] = (CROSS, CROSS, UP)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_motion_modules: bool = False
    motion_num_attention_heads: int = 8
    motion_max_seq_length: int = 32
    motion_transformer_layers_per_block: int = 1
    motion_mid_block: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def sdxl(**overrides) -> "UNetConfig":
        return UNetConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "UNetConfig":
        kw = dict(
            sample_size=16,
            block_out_channels=(32, 64),
            down_block_types=(DOWN, CROSS),
            up_block_types=(CROSS, UP),
            layers_per_block=1,
            transformer_layers_per_block=(1, 1),
            num_attention_heads=(2, 4),
            cross_attention_dim=32,
            norm_num_groups=8,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=32 + 6 * 8,
        )
        kw.update(overrides)
        return UNetConfig(**kw)


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL topology (SDXL VAE)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025

    @staticmethod
    def sdxl(**overrides) -> "VAEConfig":
        return VAEConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "VAEConfig":
        kw = dict(block_out_channels=(16, 32), layers_per_block=1,
                  norm_num_groups=8)
        kw.update(overrides)
        return VAEConfig(**kw)


@dataclass(frozen=True)
class CLIPConfig:
    """CLIP text encoder topology (SDXL uses two: ViT-L + OpenCLIP bigG)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None
    layer_norm_eps: float = 1e-5

    @staticmethod
    def sdxl_clip_l(**overrides) -> "CLIPConfig":
        return CLIPConfig(**overrides)

    @staticmethod
    def sdxl_big_g(**overrides) -> "CLIPConfig":
        kw = dict(hidden_size=1280, intermediate_size=5120, num_layers=32,
                  num_heads=20, hidden_act="gelu", projection_dim=1280)
        kw.update(overrides)
        return CLIPConfig(**kw)

    @staticmethod
    def tiny(**overrides) -> "CLIPConfig":
        kw = dict(vocab_size=1000, hidden_size=16, intermediate_size=32,
                  num_layers=2, num_heads=2, projection_dim=16)
        kw.update(overrides)
        return CLIPConfig(**kw)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
