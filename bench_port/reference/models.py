"""Plain PyTorch reference of the models the benchmark drives: the SDXL
UNet (with AnimateDiff's motion modules and the UnZipLoRA branches applied
live), the VAE decoder and the two CLIP text encoders.

It imports nothing of the program and nothing of JAX. Parameters are
nested dicts in the layout the program takes (linear ``weight`` (out,
in), conv ``weight`` OIHW, activations NHWC), so the benchmark builds one
tree from the seed and hands the same tensors to both sides; every weight
is cast to float32 where it is used.

All arithmetic is float32 (the caller turns TF32 off). ``Numerics`` holds
the one precision switch the control needs: with ``fp8`` the operands of
every linear and convolution of the bf16 models are rounded to
float8_e4m3 (a per-tensor scale) before the float32 product, which is the
lower precision a later change could be tempted by.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CROSS = "crossattn"
FP8_MAX = 448.0
VAE_EPS = 1e-6
# the scores of one attention block stay under this many bytes
ATTN_BLOCK_BYTES = 1 << 30


class Numerics:
    """fp32 everywhere; ``fp8=True`` rounds the operands of linears and
    convolutions to e4m3 (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t):
        t = t.float()
        if not self.fp8:
            return t
        s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s


FP32 = Numerics()


# ---- layers (NHWC activations) -------------------------------------------

def linear(p, x, nx: Numerics = FP32):
    b = p.get("bias")
    return F.linear(nx.q(x), nx.q(p["weight"]),
                    None if b is None else b.float())


def conv2d(p, x, nx: Numerics = FP32, *, stride: int = 1, pad=None):
    w = p["weight"]
    pad = w.shape[-1] // 2 if pad is None else pad
    lead = x.shape[:-3]
    x4 = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    b = p.get("bias")
    y = F.conv2d(nx.q(x4), nx.q(w), None if b is None else b.float(),
                 stride=stride, padding=pad).permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def group_norm(p, x, groups: int, eps: float):
    """torch.nn.GroupNorm over NHWC input (B, ..., C), float32."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * p["weight"].float() + p["bias"].float()


def layer_norm(p, x, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(),
                        p["bias"].float(), eps)


def attend(q, k, v, mask=None):
    """softmax(q k^T / sqrt(d)) v over (B, S, H, D) inputs -> (B, Sq, H*D),
    float32, in blocks of batch rows and query rows so that one block's
    scores stay under ``ATTN_BLOCK_BYTES``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().permute(0, 2, 3, 1)
    vh = v.float().permute(0, 2, 1, 3)
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    per = max(ATTN_BLOCK_BYTES // (4 * sk * h), 1)    # query rows a block
    step_q = min(sq, per)
    step_b = max(per // sq, 1) if step_q == sq else 1
    scale = d ** -0.5
    for i in range(0, b, step_b):
        for j in range(0, sq, step_q):
            s = torch.matmul(qh[i:i + step_b, :, j:j + step_q],
                             kh[i:i + step_b]) * scale
            if mask is not None:
                s = s + mask[..., j:j + step_q, :]
            out[i:i + step_b, :, j:j + step_q] = torch.matmul(
                torch.softmax(s, dim=-1), vh[i:i + step_b])
    return out.permute(0, 2, 1, 3).reshape(b, sq, h * d)


def heads(x, n: int):
    return x.unflatten(-1, (n, x.shape[-1] // n))


# ---- LoRA branches ---------------------------------------------------------

def _gate(lp, st, branch: str, with_merge: bool):
    g = torch.ones_like(lp[f"merge_{branch}"], dtype=torch.float32)
    if with_merge:
        g = g * lp[f"merge_{branch}"].float()
    if st is not None:
        mask = torch.where(st[f"use_mask_{branch}"],
                           st[f"mask_{branch}"].float(), torch.ones_like(g))
        g = g * mask * st[f"on_{branch}"].float()
    return g


def unzip_delta(lp, st, xc, xs, mode: str):
    """The UnZipLoRA delta of one projection: (x @ down) @ (up * gate),
    float32, content branch on the content stream, style on the style
    stream."""
    def branch(name, x, merge):
        g = _gate(lp, st, name, merge)
        return (x.float() @ lp[name]["down"].float()) @ (
            lp[name]["up"].float() * g[None, :])
    if mode == "both":
        return branch("content", xc, True) + branch("style", xs, True)
    if mode in ("content", "style"):
        return branch(mode, xc if mode == "content" else xs, False)
    raise ValueError(mode)


def proj(p, x, nx, *, xc=None, xs=None, mode="base", st=None):
    y = linear(p, x, nx)
    if mode != "base" and "lora" in p:
        y = y + unzip_delta(p["lora"], st, x if xc is None else xc,
                            x if xs is None else xs, mode)
    return y


def sub(tree, *path):
    for k in path:
        if tree is None:
            return None
        tree = tree.get(k)
    return tree


# ---- embeddings ------------------------------------------------------------

def sinusoidal(t, dim: int, flip: bool = True, shift: float = 0.0):
    half = dim // 2
    ex = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                           device=t.device)
    args = t.float()[..., None] * torch.exp(ex / (half - shift))
    s, c = torch.sin(args), torch.cos(args)
    return torch.cat([c, s] if flip else [s, c], dim=-1)


def mlp_embed(p, x, nx):
    return linear(p["linear_2"], F.silu(linear(p["linear_1"], x, nx)), nx)


def frame_pe(frames: int, dim: int, max_len: int, device):
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)[:, : dim // 2]
    return pe[:frames]


# ---- blocks ----------------------------------------------------------------

def resnet(p, x, temb, nx, groups: int, eps: float):
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x, groups, eps)),
               nx)
    if temb is not None and "time_emb_proj" in p:
        h = h + linear(p["time_emb_proj"], F.silu(temb), nx)[:, None, None]
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h, groups, eps)),
               nx)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, nx)
    return x.float() + h


def downsample(p, x, nx):
    return conv2d(p["conv"], F.pad(x, (0, 0, 0, 1, 0, 1)), nx, stride=2,
                  pad=0)


def upsample(p, x, nx):
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return conv2d(p["conv"], y.reshape(n, 2 * h, 2 * w, c), nx)


def geglu_ff(p, x, nx):
    hg = linear(p["proj"], x, nx)
    h, g = hg.chunk(2, dim=-1)
    return linear(p["out"], h * F.gelu(g), nx)


def spatial_attention(p, x, ctx, n_heads: int, nx, mode, st, frames: int):
    """attn1 (ctx None) or attn2 over (combined, content, style) prompt
    states of the CFG rows, repeated for each frame."""
    q = proj(p["to_q"], x, nx, mode=mode, st=sub(st, "to_q"))
    if ctx is None:
        k = proj(p["to_k"], x, nx, mode=mode, st=sub(st, "to_k"))
        v = proj(p["to_v"], x, nx, mode=mode, st=sub(st, "to_v"))
    else:
        c, cc, cs = ctx
        k = proj(p["to_k"], c, nx, xc=cc, xs=cs, mode=mode,
                 st=sub(st, "to_k"))
        v = proj(p["to_v"], c, nx, xc=cc, xs=cs, mode=mode,
                 st=sub(st, "to_v"))
        if frames > 1:
            k = k.repeat_interleave(frames, dim=0)
            v = v.repeat_interleave(frames, dim=0)
    o = attend(heads(q, n_heads), heads(k, n_heads), heads(v, n_heads))
    return proj(p["to_out"], o, nx, mode=mode, st=sub(st, "to_out"))


def transformer_2d(p, x, ctx, n_heads, groups, nx, mode, st, frames):
    n, h, w, c = x.shape
    y = group_norm(p["norm"], x, groups, 1e-6)
    y = linear(p["proj_in"], y.reshape(n, h * w, c), nx)
    for i, bp in enumerate(p["transformer_blocks"]):
        bst = sub(st, "transformer_blocks", i)
        y = y + spatial_attention(bp["attn1"], layer_norm(bp["norm1"], y),
                                  None, n_heads, nx, mode, sub(bst, "attn1"),
                                  frames)
        y = y + spatial_attention(bp["attn2"], layer_norm(bp["norm2"], y),
                                  ctx, n_heads, nx, mode, sub(bst, "attn2"),
                                  frames)
        y = y + geglu_ff(bp["ff"], layer_norm(bp["norm3"], y), nx)
    y = linear(p["proj_out"], y, nx)
    return y.reshape(n, h, w, c) + x.float()


def temporal_attention(p, x, n_heads, nx):
    """x (F, N, C): attention over the frame axis for each pixel."""
    q, k, v = (proj(p[n], x, nx) for n in ("to_q", "to_k", "to_v"))
    f, n, _ = q.shape
    # (F, N, H, d) -> (N, F, H, d): the frames of a pixel are one sequence
    q, k, v = (heads(t, n_heads).transpose(0, 1) for t in (q, k, v))
    o = attend(q, k, v)                               # (N, F, H*d)
    return proj(p["to_out"], o.transpose(0, 1), nx)


def motion_module(p, x, frames, n_heads, groups, max_len, nx):
    bf, h, w, c = x.shape
    b = bf // frames
    y = group_norm(p["norm"], x.reshape(b, frames * h, w, c), groups, 1e-6)
    y = y.reshape(b, frames, h * w, c).transpose(0, 1) \
        .reshape(frames, b * h * w, c)
    y = linear(p["proj_in"], y, nx)
    pe = frame_pe(frames, c, max_len, x.device)[:, None, :]
    for bp in p["transformer_blocks"]:
        y = y + temporal_attention(bp["attn1"],
                                   layer_norm(bp["norm1"], y) + pe,
                                   n_heads, nx)
        y = y + temporal_attention(bp["attn2"],
                                   layer_norm(bp["norm2"], y) + pe,
                                   n_heads, nx)
        y = y + geglu_ff(bp["ff"], layer_norm(bp["norm3"], y), nx)
    y = linear(p["proj_out"], y, nx)
    y = y.reshape(frames, b, h, w, c).transpose(0, 1).reshape(bf, h, w, c)
    return y + x.float()


# ---- UNet ------------------------------------------------------------------

def unet(params, cfg: dict, sample, t, ctx, pooled, time_ids, *,
         frames: int = 1, mode: str = "base", state=None,
         nx: Numerics = FP32):
    """eps prediction, float32. sample (B*F, H, W, C_in); t scalar or (B,);
    ctx (combined, content, style), each (B, S, D) (content and style may
    be None: the combined states); pooled (B, P); time_ids (B, 6)."""
    n = sample.shape[0]
    b = n // frames
    dev = sample.device
    ch = cfg["block_out_channels"]
    groups = cfg["norm_num_groups"]
    eps = cfg["norm_eps"]
    ts = torch.as_tensor(t, device=dev, dtype=torch.float32)
    if ts.dim() == 0:
        ts = ts.expand(b)
    emb = mlp_embed(params["time_embedding"], sinusoidal(ts, ch[0]), nx)
    tid = sinusoidal(time_ids.reshape(-1).float(),
                     cfg["addition_time_embed_dim"]).reshape(b, -1)
    emb = emb + mlp_embed(params["add_embedding"],
                          torch.cat([pooled.float(), tid], dim=-1), nx)
    emb = emb.repeat_interleave(frames, dim=0)
    c0 = ctx[0].float()
    ctx = (c0, c0 if ctx[1] is None else ctx[1].float(),
           c0 if ctx[2] is None else ctx[2].float())
    motion = cfg["use_motion_modules"] and frames > 1

    def attn(ap, h, idx, st):
        return transformer_2d(ap, h, ctx, cfg["num_attention_heads"][idx],
                              groups, nx, mode, st, frames)

    def mm(mp, h):
        return motion_module(mp, h, frames, cfg["motion_num_attention_heads"],
                             groups, cfg["motion_max_seq_length"], nx)

    h = conv2d(params["conv_in"], sample, nx)
    skips = [h]
    for i, blk in enumerate(params["down_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            h = resnet(rp, h, emb, nx, groups, eps)
            if cfg["down_block_types"][i] == CROSS:
                h = attn(blk["attentions"][j], h, i,
                         sub(state, "down_blocks", i, "attentions", j))
            if motion and blk.get("motion_modules"):
                h = mm(blk["motion_modules"][j], h)
            skips.append(h)
        if "downsamplers" in blk:
            h = downsample(blk["downsamplers"][0], h, nx)
            skips.append(h)
    mid = params["mid_block"]
    h = resnet(mid["resnets"][0], h, emb, nx, groups, eps)
    h = attn(mid["attentions"][0], h, -1,
             sub(state, "mid_block", "attentions", 0))
    if motion and mid.get("motion_modules"):
        h = mm(mid["motion_modules"][0], h)
    h = resnet(mid["resnets"][1], h, emb, nx, groups, eps)
    for i, blk in enumerate(params["up_blocks"]):
        idx = len(ch) - 1 - i
        for j, rp in enumerate(blk["resnets"]):
            h = resnet(rp, torch.cat([h, skips.pop().float()], dim=-1), emb,
                       nx, groups, eps)
            if cfg["up_block_types"][i] == CROSS:
                h = attn(blk["attentions"][j], h, idx,
                         sub(state, "up_blocks", i, "attentions", j))
            if motion and blk.get("motion_modules"):
                h = mm(blk["motion_modules"][j], h)
        if "upsamplers" in blk:
            h = upsample(blk["upsamplers"][0], h, nx)
    h = F.silu(group_norm(params["conv_norm_out"], h, groups, eps))
    return conv2d(params["conv_out"], h, nx)


# ---- VAE decoder -----------------------------------------------------------

def _vae_mid(p, x, groups, nx):
    x = resnet(p["resnets"][0], x, None, nx, groups, VAE_EPS)
    a = p["attentions"][0]
    n, h, w, c = x.shape
    y = group_norm(a["group_norm"], x, groups, VAE_EPS).reshape(n, h * w, c)
    q, k, v = (linear(a[nm], y, nx) for nm in ("to_q", "to_k", "to_v"))
    o = attend(heads(q, 1), heads(k, 1), heads(v, 1))
    x = x + linear(a["to_out"], o, nx).reshape(n, h, w, c)
    return resnet(p["resnets"][1], x, None, nx, groups, VAE_EPS)


def vae_decode(params, cfg: dict, z, nx: Numerics = FP32):
    """z (N, h, w, 4) scaled latents -> (N, 8h, 8w, 3) float32."""
    g = cfg["norm_num_groups"]
    dec = params["decoder"]
    h = conv2d(params["post_quant_conv"], z.float() / cfg["scaling_factor"],
               nx)
    h = conv2d(dec["conv_in"], h, nx)
    h = _vae_mid(dec["mid_block"], h, g, nx)
    for blk in dec["up_blocks"]:
        for rp in blk["resnets"]:
            h = resnet(rp, h, None, nx, g, VAE_EPS)
        if "upsamplers" in blk:
            h = upsample(blk["upsamplers"][0], h, nx)
    h = F.silu(group_norm(dec["conv_norm_out"], h, g, VAE_EPS))
    return conv2d(dec["conv_out"], h, nx)


# ---- CLIP ------------------------------------------------------------------

def clip(params, cfg: dict, ids, eos: int, nx: Numerics = FP32):
    """(penultimate hidden (B, S, D), pooled (B, P)), float32."""
    b, s = ids.shape
    x = params["token_embedding"][ids].float() \
        + params["position_embedding"][None, :s].float()
    mask = torch.triu(torch.full((s, s), float("-inf"), device=x.device),
                      diagonal=1)[None, None]
    n_heads = cfg["num_heads"]
    eps = cfg["layer_norm_eps"]
    if cfg["hidden_act"] == "quick_gelu":
        def act(t):
            return t * torch.sigmoid(1.702 * t)
    else:
        act = F.gelu

    def layer(x_, lp):
        h = layer_norm(lp["layer_norm1"], x_, eps)
        q, k, v = (heads(linear(lp[nm], h, nx), n_heads)
                   for nm in ("q_proj", "k_proj", "v_proj"))
        x_ = x_ + linear(lp["out_proj"], attend(q, k, v, mask), nx)
        h = layer_norm(lp["layer_norm2"], x_, eps)
        return x_ + linear(lp["fc2"], act(linear(lp["fc1"], h, nx)), nx)

    for lp in params["layers"][:-1]:
        x = layer(x, lp)
    pen = x
    x = layer(x, params["layers"][-1])
    last = layer_norm(params["final_layer_norm"], x, eps)
    pos = (ids == eos).int().argmax(dim=-1)
    pooled = last[torch.arange(b, device=x.device), pos]
    if "text_projection" in params:
        pooled = linear(params["text_projection"], pooled, nx)
    return pen, pooled


def encode_prompt(clip_l, cfg_l, clip_g, cfg_g, ids_l, ids_g,
                  nx: Numerics = FP32):
    """SDXL's conditioning: both penultimate states side by side, and
    bigG's projected pooled state."""
    pen_l, _ = clip(clip_l, cfg_l, ids_l, cfg_l["vocab_size"] - 1, nx)
    pen_g, pooled = clip(clip_g, cfg_g, ids_g, cfg_g["vocab_size"] - 1, nx)
    return torch.cat([pen_l, pen_g], dim=-1), pooled
