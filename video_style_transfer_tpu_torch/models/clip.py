"""CLIP text encoders (SDXL: CLIP ViT-L + OpenCLIP bigG), functional.
SDXL consumes the penultimate hidden state of both encoders concatenated
to 2048 channels and the big encoder's projected pooled embedding. The
causal self-attention over 77 tokens stays plain PyTorch."""
from __future__ import annotations

from typing import Tuple

import torch

from video_style_transfer_tpu_torch.config import CLIPConfig
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.ops.attention import (
    merge_heads, split_heads)


def _init_clip_layer(ini, cfg: CLIPConfig):
    d = cfg.hidden_size
    return {
        "layer_norm1": layers.init_norm(ini, d),
        "q_proj": layers.init_linear(ini, d, d),
        "k_proj": layers.init_linear(ini, d, d),
        "v_proj": layers.init_linear(ini, d, d),
        "out_proj": layers.init_linear(ini, d, d),
        "layer_norm2": layers.init_norm(ini, d),
        "fc1": layers.init_linear(ini, d, cfg.intermediate_size),
        "fc2": layers.init_linear(ini, cfg.intermediate_size, d),
    }


def init_clip(ini, cfg: CLIPConfig):
    d = cfg.hidden_size
    p = {
        "token_embedding": ini.normal((cfg.vocab_size, d), 0.02),
        "position_embedding": ini.normal((cfg.max_position_embeddings, d),
                                         0.01),
        "layers": [_init_clip_layer(ini, cfg) for _ in range(cfg.num_layers)],
        "final_layer_norm": layers.init_norm(ini, d),
    }
    if cfg.projection_dim is not None:
        p["text_projection"] = layers.init_linear(ini, d, cfg.projection_dim,
                                                  bias=False)
    return p


def _attn(lp, x, mask, num_heads):
    q = split_heads(layers.linear(lp["q_proj"], x), num_heads)
    k = split_heads(layers.linear(lp["k_proj"], x), num_heads)
    v = split_heads(layers.linear(lp["v_proj"], x), num_heads)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    w = torch.softmax(logits + mask, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", w, v)
    return layers.linear(lp["out_proj"], merge_heads(o))


def _act(cfg):
    return layers.quick_gelu if cfg.hidden_act == "quick_gelu" else layers.gelu


def clip_apply(params, cfg: CLIPConfig, input_ids, *,
               eos_token_id: int = 49407) -> Tuple:
    """input_ids: (B, S) int. Returns (penultimate_hidden, last_hidden,
    pooled): pooled is the hidden state at the first EOS token,
    projected when the config has a text_projection."""
    b, s = input_ids.shape
    x = params["token_embedding"][input_ids]
    x = x + params["position_embedding"][None, :s]
    mask = torch.triu(torch.full((s, s), float("-inf"), device=x.device),
                      diagonal=1)[None, None]
    act = _act(cfg)

    def body(x_, lp):
        h = layers.layer_norm(lp["layer_norm1"], x_, eps=cfg.layer_norm_eps)
        x_ = x_ + _attn(lp, h, mask, cfg.num_heads)
        h = layers.layer_norm(lp["layer_norm2"], x_, eps=cfg.layer_norm_eps)
        return x_ + layers.linear(lp["fc2"], act(layers.linear(lp["fc1"], h)))

    for lp in params["layers"][:-1]:
        x = body(x, lp)
    penultimate = x
    x = body(x, params["layers"][-1])
    last = layers.layer_norm(params["final_layer_norm"], x,
                             eps=cfg.layer_norm_eps)
    eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    pooled = last[torch.arange(b, device=x.device), eos_pos]
    if "text_projection" in params:
        pooled = layers.linear(params["text_projection"], pooled)
    return penultimate, last, pooled


def encode_sdxl_prompt(params_l, cfg_l, params_g, cfg_g, ids_l, ids_g, *,
                       eos_l: int = 49407, eos_g: int = 49407):
    """(embeds (B, S, 768 + 1280), pooled (B, proj))."""
    pen_l, _, _ = clip_apply(params_l, cfg_l, ids_l, eos_token_id=eos_l)
    pen_g, _, pooled = clip_apply(params_g, cfg_g, ids_g, eos_token_id=eos_g)
    return torch.cat([pen_l, pen_g], dim=-1), pooled
