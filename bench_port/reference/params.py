"""The parameter trees of the reference models, in the layout the program
takes, drawn through an initialiser with ``uniform(shape, bound)``,
``normal(shape, std)``, ``ones(n)`` and ``zeros(n)``: the torch default
bounds U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for linears and convolutions,
ones and zeros for the norms, N(0, 0.02) / N(0, 0.01) for CLIP's token and
position tables. ``bench_port/lib/weights.py`` turns the leaves into
seeded device tensors in a few large calls.

Also here: the UnZipLoRA factors and their column state on every
projection of every spatial attention (the paths the program's
``lora/surgery.py`` walks).
"""
from __future__ import annotations

import math

import torch

from bench_port.reference.models import CROSS

PROJS = ("to_q", "to_k", "to_v", "to_out")


def lin(ini, i, o, bias=True):
    p = {"weight": ini.uniform((o, i), 1.0 / math.sqrt(i))}
    if bias:
        p["bias"] = ini.uniform((o,), 1.0 / math.sqrt(i))
    return p


def conv(ini, i, o, k, bias=True):
    bound = 1.0 / math.sqrt(i * k * k)
    p = {"weight": ini.uniform((o, i, k, k), bound)}
    if bias:
        p["bias"] = ini.uniform((o,), bound)
    return p


def norm(ini, c):
    return {"weight": ini.ones(c), "bias": ini.zeros(c)}


def attention(ini, dim, kv_dim=None, qkv_bias=False):
    kv = kv_dim or dim
    return {"to_q": lin(ini, dim, dim, qkv_bias),
            "to_k": lin(ini, kv, dim, qkv_bias),
            "to_v": lin(ini, kv, dim, qkv_bias),
            "to_out": lin(ini, dim, dim)}


def feed_forward(ini, dim):
    return {"proj": lin(ini, dim, dim * 8), "out": lin(ini, dim * 4, dim)}


def resnet(ini, i, o, temb=None):
    p = {"norm1": norm(ini, i), "conv1": conv(ini, i, o, 3),
         "norm2": norm(ini, o), "conv2": conv(ini, o, o, 3)}
    if temb is not None:
        p["time_emb_proj"] = lin(ini, temb, o)
    if i != o:
        p["conv_shortcut"] = conv(ini, i, o, 1)
    return p


def transformer_2d(ini, c, layers, cross):
    return {"norm": norm(ini, c), "proj_in": lin(ini, c, c),
            "transformer_blocks": [
                {"norm1": norm(ini, c), "attn1": attention(ini, c),
                 "norm2": norm(ini, c), "attn2": attention(ini, c, cross),
                 "norm3": norm(ini, c), "ff": feed_forward(ini, c)}
                for _ in range(layers)],
            "proj_out": lin(ini, c, c)}


def motion_module(ini, c, layers):
    return {"norm": norm(ini, c), "proj_in": lin(ini, c, c),
            "transformer_blocks": [
                {"norm1": norm(ini, c), "attn1": attention(ini, c),
                 "norm2": norm(ini, c), "attn2": attention(ini, c),
                 "norm3": norm(ini, c), "ff": feed_forward(ini, c)}
                for _ in range(layers)],
            "proj_out": lin(ini, c, c)}


def unet(ini, cfg: dict):
    ch = cfg["block_out_channels"]
    temb = ch[0] * 4
    lpb = cfg["layers_per_block"]
    motion = cfg["use_motion_modules"]
    p = {"conv_in": conv(ini, cfg["in_channels"], ch[0], 3),
         "time_embedding": {"linear_1": lin(ini, ch[0], temb),
                            "linear_2": lin(ini, temb, temb)},
         "add_embedding": {
             "linear_1": lin(ini,
                             cfg["projection_class_embeddings_input_dim"],
                             temb),
             "linear_2": lin(ini, temb, temb)}}

    def tf(c, idx):
        return transformer_2d(ini, c, cfg["transformer_layers_per_block"][idx],
                              cfg["cross_attention_dim"])

    def mm(c):
        return motion_module(ini, c,
                             cfg["motion_transformer_layers_per_block"])

    down, out_c = [], ch[0]
    for i, kind in enumerate(cfg["down_block_types"]):
        in_c, out_c = out_c, ch[i]
        blk = {"resnets": [], "attentions": [], "motion_modules": []}
        for j in range(lpb):
            blk["resnets"].append(resnet(ini, in_c if j == 0 else out_c,
                                         out_c, temb))
            if kind == CROSS:
                blk["attentions"].append(tf(out_c, i))
            if motion:
                blk["motion_modules"].append(mm(out_c))
        if i < len(cfg["down_block_types"]) - 1:
            blk["downsamplers"] = [{"conv": conv(ini, out_c, out_c, 3)}]
        down.append(blk)
    p["down_blocks"] = down
    mid_c = ch[-1]
    p["mid_block"] = {"resnets": [resnet(ini, mid_c, mid_c, temb)
                                  for _ in range(2)],
                      "attentions": [tf(mid_c, -1)]}
    if motion and cfg["motion_mid_block"]:
        p["mid_block"]["motion_modules"] = [mm(mid_c)]
    skip = [ch[0]]
    for i in range(len(cfg["down_block_types"])):
        skip += [ch[i]] * lpb
        if i < len(cfg["down_block_types"]) - 1:
            skip.append(ch[i])
    up, cur = [], mid_c
    rev = list(reversed(ch))
    for i, kind in enumerate(cfg["up_block_types"]):
        out_c = rev[i]
        blk = {"resnets": [], "attentions": [], "motion_modules": []}
        for _ in range(lpb + 1):
            blk["resnets"].append(resnet(ini, cur + skip.pop(), out_c, temb))
            cur = out_c
            if kind == CROSS:
                blk["attentions"].append(tf(out_c, len(ch) - 1 - i))
            if motion:
                blk["motion_modules"].append(mm(out_c))
        if i < len(cfg["up_block_types"]) - 1:
            blk["upsamplers"] = [{"conv": conv(ini, out_c, out_c, 3)}]
        up.append(blk)
    p["up_blocks"] = up
    p["conv_norm_out"] = norm(ini, ch[0])
    p["conv_out"] = conv(ini, ch[0], cfg["out_channels"], 3)
    return p


def _vae_mid(ini, c):
    return {"resnets": [resnet(ini, c, c) for _ in range(2)],
            "attentions": [{"group_norm": norm(ini, c),
                            **attention(ini, c, qkv_bias=True)}]}


def vae_decoder(ini, cfg: dict):
    rev = list(reversed(cfg["block_out_channels"]))
    dec = {"conv_in": conv(ini, cfg["latent_channels"], rev[0], 3),
           "mid_block": _vae_mid(ini, rev[0]), "up_blocks": []}
    out_c = rev[0]
    for i in range(len(rev)):
        in_c, out_c = out_c, rev[i]
        blk = {"resnets": [resnet(ini, in_c if j == 0 else out_c, out_c)
                           for j in range(cfg["layers_per_block"] + 1)]}
        if i < len(rev) - 1:
            blk["upsamplers"] = [{"conv": conv(ini, out_c, out_c, 3)}]
        dec["up_blocks"].append(blk)
    dec["conv_norm_out"] = norm(ini, rev[-1])
    dec["conv_out"] = conv(ini, rev[-1], cfg["out_channels"], 3)
    return {"decoder": dec,
            "post_quant_conv": conv(ini, cfg["latent_channels"],
                                    cfg["latent_channels"], 1)}


def clip(ini, cfg: dict):
    d = cfg["hidden_size"]
    p = {"token_embedding": ini.normal((cfg["vocab_size"], d), 0.02),
         "position_embedding": ini.normal(
             (cfg["max_position_embeddings"], d), 0.01),
         "layers": [{"layer_norm1": norm(ini, d), "q_proj": lin(ini, d, d),
                     "k_proj": lin(ini, d, d), "v_proj": lin(ini, d, d),
                     "out_proj": lin(ini, d, d), "layer_norm2": norm(ini, d),
                     "fc1": lin(ini, d, cfg["intermediate_size"]),
                     "fc2": lin(ini, cfg["intermediate_size"], d)}
                    for _ in range(cfg["num_layers"])],
         "final_layer_norm": norm(ini, d)}
    if cfg.get("projection_dim"):
        p["text_projection"] = lin(ini, d, cfg["projection_dim"], bias=False)
    return p


def _attention_paths(unet_params, group: str):
    def blocks():
        for i, b in enumerate(unet_params["down_blocks"]):
            yield ("down_blocks", i), b
        yield ("mid_block",), unet_params["mid_block"]
        for i, b in enumerate(unet_params["up_blocks"]):
            yield ("up_blocks", i), b
    for prefix, blk in blocks():
        for j, mod in enumerate(blk.get(group, [])):
            for k in range(len(mod["transformer_blocks"])):
                for name in ("attn1", "attn2"):
                    yield prefix + (group, j, "transformer_blocks", k, name)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def spatial_attention_paths(unet_params):
    return list(_attention_paths(unet_params, "attentions"))



def add_unziplora(ini, unet_params, rank: int, merge_spread: float):
    """A ``lora`` entry on every q/k/v/out of every spatial attention:
    down (in, r) and up (r, out) ~ N(0, 1/r) (the program's stage-1
    init), mergers 1 + U(-spread, spread), float32."""
    for path in spatial_attention_paths(unet_params):
        a = get(unet_params, path)
        for pj in PROJS:
            o, i = a[pj]["weight"].shape
            a[pj]["lora"] = {
                "content": {"down": ini.normal((i, rank), 1.0 / rank),
                            "up": ini.normal((rank, o), 1.0 / rank)},
                "style": {"down": ini.normal((i, rank), 1.0 / rank),
                          "up": ini.normal((rank, o), 1.0 / rank)},
                "merge_content": ini.around_one((o,), merge_spread),
                "merge_style": ini.around_one((o,), merge_spread)}
    return unet_params


def unziplora_state(unet_params, device):
    """The column state of every projection the LoRA sits on, as the
    program's ``insert_unziplora`` makes it: no mask in use, both
    branches on."""
    state: dict = {}
    for path in spatial_attention_paths(unet_params):
        for pj in PROJS:
            o = get(unet_params, path)[pj]["weight"].shape[0]
            node = state
            for k in path:
                node = node.setdefault(k, {})
            entry = {}
            for b in ("content", "style"):
                entry[f"mask_{b}"] = torch.zeros(o, dtype=torch.bool,
                                                 device=device)
                entry[f"use_mask_{b}"] = torch.tensor(False, device=device)
                entry[f"on_{b}"] = torch.tensor(True, device=device)
                entry[f"score_{b}"] = torch.zeros(o, dtype=torch.float32,
                                                  device=device)
            node[pj] = entry
    return state
