"""The synthetic checkpoint of the parity runbook: a tiny diffusers-layout
directory with tokenizers, written without any real weights. (The
runbook's inventory, load, generate and compare stages are not ported
yet.)"""
from __future__ import annotations

import json
import os

import numpy as np


def make_synthetic_checkpoint(out_dir: str, seed: int = 0):
    """Write a tiny diffusers-layout checkpoint directory: seeded random
    UNet (without motion modules), VAE and CLIP weights of the
    ``tiny_checkpoint_configs`` topology as safetensors, and byte-level
    tokenizers under tokenizer/ and tokenizer_2/."""
    from video_style_transfer_tpu_torch.cli.common import (
        tiny_checkpoint_configs)
    from video_style_transfer_tpu_torch.data.tokenizer import (
        bytes_to_unicode)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.models.vae import (
        init_vae_decoder, init_vae_encoder)
    from video_style_transfer_tpu_torch.utils.hf_convert import (
        clip_source_shapes, export_to_state_dict)
    from video_style_transfer_tpu_torch.utils.safetensors_io import save_file

    ucfg, vcfg, lcfg, gcfg = tiny_checkpoint_configs()
    os.makedirs(os.path.join(out_dir, "unet"), exist_ok=True)
    save_file(export_to_state_dict(init_unet(Init(seed), ucfg)),
              os.path.join(out_dir, "unet",
                           "diffusion_pytorch_model.safetensors"))
    vae = init_vae_decoder(Init(seed + 1), vcfg)
    vae.update(init_vae_encoder(Init(seed + 2), vcfg))
    os.makedirs(os.path.join(out_dir, "vae"), exist_ok=True)
    save_file(export_to_state_dict(vae),
              os.path.join(out_dir, "vae",
                           "diffusion_pytorch_model.safetensors"))

    # CLIP weights straight from the load contract, ~N(0, 0.02) like
    # transformers' init
    rng = np.random.default_rng(seed)
    for sub, cfg in (("text_encoder", lcfg), ("text_encoder_2", gcfg)):
        sd = {k: rng.normal(0, 0.02, s).astype(np.float32)
              for k, s in clip_source_shapes(cfg).items()}
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        save_file(sd, os.path.join(out_dir, sub, "model.safetensors"))

    # byte-level tokenizers: every single byte is a token, no merges (a
    # valid BPE; 256 + 256 "</w>" + bos/eos = 514 ids fit the tiny
    # vocabulary of 1000)
    syms = list(bytes_to_unicode().values())
    vocab = {}
    for s in syms:
        vocab[s] = len(vocab)
    for s in syms:
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    for sub in ("tokenizer", "tokenizer_2"):
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
    return out_dir
