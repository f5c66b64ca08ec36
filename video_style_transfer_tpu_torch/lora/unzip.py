"""UnZipLoRA dual-branch LoRA (the JAX package's lora/unzip.py forward).

- ``params`` (trainable in stage 1, frozen in stage 2): content/style
  ``down`` (in, r) and ``up`` (r, out) matrices and per-output-column
  merger vectors ``merge_content`` / ``merge_style``;
- ``state`` (never trainable): boolean column masks, mask-enable flags,
  branch gates and cone scores;
- ``mode``: "base" | "both" | "content" | "style".

The delta runs in the factored rank-space form ``(x @ down) @ (up *
gate)`` in fp32 whatever the activation dtype, and is rounded once to it;
the gate is merge x mask x on per output column ("both") or mask x on
("content"/"style": the single-branch modes skip the merger). The LoRA
matrices keep the JAX (in, r) / (r, out) orientation, so ``x @ down``
needs no transpose.

Stage 1's column separation reads the merger similarity and the cone
(W .* dW, the gradient-importance score that picks each branch's
columns) from here.
"""
from __future__ import annotations

import math

import torch

from video_style_transfer_tpu_torch.models import layers

BRANCHES = ("content", "style")
# a cone element counts toward its column's score above this, strictly
# (the reference's threshold)
CONE_THRESHOLD = 1e-5


def init_unzip_lora_params(ini, in_features: int, out_features: int,
                           rank: int = 64, dtype=torch.float32):
    """down and up ~ N(0, 1/rank) (the reference does not zero-init up,
    so the delta is nonzero at step 0); mergers start at one."""
    std = 1.0 / rank

    def pair():
        return {"down": ini.normal((in_features, rank), std, dtype),
                "up": ini.normal((rank, out_features), std, dtype)}

    ones = torch.ones(out_features, dtype=dtype, device=ini.device)
    return {"content": pair(), "style": pair(),
            "merge_content": ones, "merge_style": ones.clone()}


def init_unzip_lora_state(out_features: int, device="cpu"):
    """mask_* hard column filter, use_mask_* whether it applies, on_*
    branch gate, score_* cone column scores."""
    st = {}
    for b in BRANCHES:
        st[f"mask_{b}"] = torch.zeros(out_features, dtype=torch.bool,
                                      device=device)
        st[f"use_mask_{b}"] = torch.tensor(False, device=device)
        st[f"on_{b}"] = torch.tensor(True, device=device)
        st[f"score_{b}"] = torch.zeros(out_features, dtype=torch.float32,
                                       device=device)
    return st


def _column_gate(params, state, branch: str, with_merge: bool):
    """Per-output-column multiplicative gate of one branch."""
    merge = params[f"merge_{branch}"]
    gate = torch.ones_like(merge)
    if with_merge:
        gate = gate * merge
    if state is not None:
        mask = torch.where(state[f"use_mask_{branch}"],
                           state[f"mask_{branch}"].to(gate.dtype),
                           torch.ones_like(gate))
        gate = gate * mask * state[f"on_{branch}"].to(gate.dtype)
    return gate


def _branch_out(params, state, branch, x32, with_merge):
    p = params[branch]
    gate = _column_gate(params, state, branch, with_merge)
    h = x32 @ p["down"].float()
    return h @ (p["up"].float() * gate.float()[None, :])


def apply_unzip_lora(params, x_content, x_style=None, *, mode: str = "both",
                     state=None):
    """The LoRA delta (to add to the base projection), in x's dtype."""
    out_features = params["merge_content"].shape[0]
    if mode == "base":
        return x_content.new_zeros(x_content.shape[:-1] + (out_features,))
    if x_style is None:
        x_style = x_content
    c32 = x_content.float()
    s32 = c32 if x_style is x_content else x_style.float()
    if mode == "both":
        out = (_branch_out(params, state, "content", c32, True)
               + _branch_out(params, state, "style", s32, True))
    elif mode == "content":
        out = _branch_out(params, state, "content", c32, False)
    elif mode == "style":
        out = _branch_out(params, state, "style", s32, False)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out.to(x_content.dtype)


def dual_linear(p, x, x_content=None, x_style=None, *, mode: str = "base",
                state=None):
    """Base linear in the activation dtype plus, outside "base" mode, the
    fp32 UnZipLoRA delta of the content/style streams (both default to
    x)."""
    y = layers.linear(p, x)
    if mode != "base" and "lora" in p:
        y = y + apply_unzip_lora(
            p["lora"], x if x_content is None else x_content,
            x if x_style is None else x_style, mode=mode, state=state)
    return y


def composed_delta(params, branch: str, with_merge: bool = False):
    """The composed (in, out) LoRA delta W = down @ up [* merge]."""
    w = params[branch]["down"] @ params[branch]["up"]
    if with_merge:
        w = w * params[f"merge_{branch}"][None, :]
    return w


def folded_delta(params, state, *, mode: str = "both"):
    """The composed, fully gated (in, out) delta this layer adds when both
    input streams coincide, in f32 — for folding into the base weight at
    load time. Matches apply_unzip_lora's per-mode gating exactly."""
    def one(branch, with_merge):
        gate = _column_gate(params, state, branch, with_merge)
        return ((params[branch]["down"].float() @ params[branch]["up"].float())
                * gate.float()[None])

    if mode == "both":
        return one("content", True) + one("style", True)
    if mode == "content":
        return one("content", False)
    if mode == "style":
        return one("style", False)
    raise ValueError(mode)


def export_weights(params, state, branch: str):
    """(down, up) in the reference save orientation ((r, in), (out, r))
    with the column gate folded into up: the mask if the filter is
    active, else the merger."""
    down = params[branch]["down"].t()
    up = params[branch]["up"].t()
    if state is not None and bool(state[f"use_mask_{branch}"]):
        gate = state[f"mask_{branch}"].to(up.dtype)
    else:
        gate = params[f"merge_{branch}"]
    return down, up * gate[:, None]


def mergers_similarity(params, state=None):
    """mean |merge_content * merge_style| of one layer; once both column
    masks are in use, the mergers are first multiplied by their masks."""
    mc, ms = params["merge_content"], params["merge_style"]
    plain = torch.mean(torch.abs(mc * ms))
    if state is None:
        return plain
    masked = torch.mean(torch.abs((mc * state["mask_content"])
                                  * (ms * state["mask_style"])))
    both = state["use_mask_content"] & state["use_mask_style"]
    return torch.where(both, masked, plain)


def cone_matrix(params, grads, branch: str, dtype=None):
    """cone = W .* dW of one layer, (in, out), with W = down @ up (no
    merger) and dW by the product rule with the merger term:
    dW = (d_down @ up + down @ d_up) * merge + W * d_merge. `dtype`: the
    arithmetic's (default: the factors')."""
    def c(t):
        return t if dtype is None else t.to(dtype)

    down, up = c(params[branch]["down"]), c(params[branch]["up"])
    g_down, g_up = c(grads[branch]["down"]), c(grads[branch]["up"])
    merge = c(params[f"merge_{branch}"])
    g_merge = c(grads[f"merge_{branch}"])
    w = down @ up
    dw = (g_down @ up + down @ g_up) * merge[None, :] + w * g_merge[None, :]
    return w * dw


def cone_columns(params, grads, branch: str):
    """Per-column cone score, float32 (out,): the fraction of rows whose
    |cone| exceeds CONE_THRESHOLD (strictly). The cone is computed in
    float64 from the float32 factors, whose products it holds exactly:
    the sums of the card and of the CPU differ by ~1e-16 relative, so the
    same elements pass the threshold on both (a float32 cone differs
    between them in its last bits, and an element within them of 1e-5
    would change a column's count)."""
    cone = cone_matrix(params, grads, branch, torch.float64)
    count = torch.sum(torch.abs(cone) > CONE_THRESHOLD, dim=0)
    # divided by a tensor: a division by a host number becomes a product
    # by its reciprocal on the card, which rounds differently
    rows = torch.tensor(float(cone.shape[0]), device=count.device)
    return count.to(torch.float32) / rows


def select_columns(score_content, score_style, prev_mask_content,
                   prev_mask_style, *, ratio: float, avoid: bool = True):
    """Top-k column selection with content priority, OR'd with the
    previous masks. k = max(int(out * ratio), 1). Content takes the
    columns scoring strictly above its k-th best score; with `avoid`,
    the columns content holds score -inf before the style pick. Only the
    k-th value is read, so ties among the scores (a score is a count over
    the rows) decide nothing but that threshold."""
    k = max(int(score_content.shape[0] * ratio), 1)
    thresh_c = torch.topk(score_content, k).values[-1]
    mask_content = (score_content > thresh_c) | prev_mask_content
    masked_style = score_style
    if avoid:
        masked_style = torch.where(mask_content,
                                   torch.full_like(score_style, -math.inf),
                                   score_style)
    thresh_s = torch.topk(masked_style, k).values[-1]
    mask_style = (masked_style > thresh_s) | prev_mask_style
    return mask_content, mask_style
