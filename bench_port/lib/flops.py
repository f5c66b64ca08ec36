"""Model flops of a request, counted by ``torch.utils.flop_counter`` over
the reference run on ``meta`` tensors at the traffic's shapes: no
device, no data, nothing of the program. Products and convolutions are
counted (2 flops a multiply-add); the UNet is counted without the LoRA
branches, which the serving paths fold into the weights."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.lib import weights
from bench_port.reference import models as ref
from bench_port.reference import params as refp


def count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def unet_call(cfg: dict, rows: int, frames: int, h: int, w: int) -> int:
    """One CFG-pair UNet call on `rows` latent rows (2 rows a row)."""
    u = cfg["unet"]
    p = refp.unet(weights.Recorder(torch.float32), u)
    b = 2 * rows // frames
    return count(lambda: ref.unet(
        p, u, _meta((2 * rows, h, w, u["in_channels"])), 1.0,
        (_meta((b, 77, u["cross_attention_dim"])), None, None),
        _meta((b, u["projection_class_embeddings_input_dim"]
               - 6 * u["addition_time_embed_dim"])), _meta((b, 6)),
        frames=frames))


def prompt_encode(cfg: dict) -> int:
    total = 0
    for name in ("clip_l", "clip_g"):
        c = cfg[name]
        p = refp.clip(weights.Recorder(torch.float32), c)
        ids = torch.empty((1, c["max_position_embeddings"]), device="meta",
                          dtype=torch.long)
        total += count(lambda: ref.clip(p, c, ids, c["vocab_size"] - 1))
    return total


def vae_decode(cfg: dict, h: int, w: int) -> int:
    v = cfg["vae"]
    p = refp.vae_decoder(weights.Recorder(torch.float32), v)
    return count(lambda: ref.vae_decode(
        p, v, _meta((1, h, w, v["latent_channels"]))))


def serve_request(cfg: dict, traffic: dict):
    """(flops in the UNet's and CLIPs' dtype, flops of the decode) of one
    request: its prompt encodes, every denoise step, every frame's
    decode."""
    video = traffic["pipeline"] == "video"
    rows = traffic["frames"] if video else len(traffic["noise_seeds"])
    frames = traffic["frames"] if video else 1
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    h, w = traffic["height"] // f, traffic["width"] // f
    prompts = traffic["prompts"][0]
    encodes = sum(prompts.get(k) is not None
                  for k in ("prompt", "content", "style"))
    low = (traffic["steps"] * unet_call(cfg, rows, frames, h, w)
           + encodes * prompt_encode(cfg))
    return low, rows * vae_decode(cfg, h, w)
