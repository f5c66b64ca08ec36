"""Multi-head attention and the GEGLU feed-forward.

Counterpart of the JAX package's models/attention.py. Each projection is
``dual_linear`` over a params dict that may carry a ``lora`` (UnZipLoRA,
used outside "base" mode with its ``state``) or a ``tlora`` (temporal
LoRA) entry. Self-attention without either runs one fused (C, 3*inner)
projection whose output the flash kernel reads in place; with one it
projects q, k and v separately. Threading of the three streams:

- q and out projections, self-attention k/v: the hidden states;
- cross-attention k/v: the (combined, content, style) prompt embeddings
  (content/style default to the combined one);
- cross-attention may take precomputed prompt k/v instead.

Under tensor parallelism (parallel/tensor.py) an attention or
feed-forward sliced for this rank carries a ``ModelShard`` under
``"tp"``: the attention runs at the rank's head count, and ``to_out``
and ``ff.out`` add their partial products (LoRA branches included) over
the model group before their bias.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from video_style_transfer_tpu_torch.lora.temporal import apply_temporal_lora
from video_style_transfer_tpu_torch.lora.unzip import (
    apply_unzip_lora, dual_linear)
from video_style_transfer_tpu_torch.models import layers
from video_style_transfer_tpu_torch.ops.attention import (
    merge_heads, sdpa, sdpa_fused_qkv, split_heads)
from video_style_transfer_tpu_torch.ops.geglu import geglu_projection
from video_style_transfer_tpu_torch.parallel.tensor import reduce_partial

_QKV = ("to_q", "to_k", "to_v")


def init_attention(ini, query_dim: int, *, heads: int,
                   dim_head: Optional[int] = None,
                   cross_attention_dim: Optional[int] = None,
                   out_bias: bool = True, qkv_bias: bool = False):
    if dim_head is None:
        dim_head = query_dim // heads
    inner = heads * dim_head
    kv_dim = cross_attention_dim or query_dim
    return {
        "to_q": layers.init_linear(ini, query_dim, inner, bias=qkv_bias),
        "to_k": layers.init_linear(ini, kv_dim, inner, bias=qkv_bias),
        "to_v": layers.init_linear(ini, kv_dim, inner, bias=qkv_bias),
        "to_out": layers.init_linear(ini, inner, query_dim, bias=out_bias),
    }


def fused_qkv_projection(p, x):
    """One (C, 3*inner) matmul for q, k and v (matmul columns are
    independent, so this equals three separate projections)."""
    w = torch.cat([p[n]["weight"].to(x.dtype) for n in _QKV], dim=0)
    b = None
    if any("bias" in p[n] for n in _QKV):
        b = torch.cat([p[n]["bias"].to(x.dtype) if "bias" in p[n] else
                       torch.zeros(p[n]["weight"].shape[0], dtype=x.dtype,
                                   device=x.device) for n in _QKV])
    return F.linear(x, w, b)


def _proj(p, st, name, x, x_c, x_s, mode):
    sub = None if st is None else st.get(name)
    y = dual_linear(p[name], x, x_c, x_s, mode=mode, state=sub)
    if "tlora" in p[name]:
        y = y + apply_temporal_lora(p[name]["tlora"], x)
    return y


def _row_parallel(pp, st, x, mode, shard):
    """A row-parallel projection of a model shard: this rank's partial
    product and its LoRA branches' partials, summed over the model group,
    then the bias."""
    y = F.linear(x, pp["weight"].to(x.dtype))
    if mode != "base" and "lora" in pp:
        y = y + apply_unzip_lora(pp["lora"], x, x, mode=mode, state=st)
    if "tlora" in pp:
        y = y + apply_temporal_lora(pp["tlora"], x)
    y = reduce_partial(y, shard)
    return y if "bias" not in pp else y + pp["bias"].to(y.dtype)


def _out(p, st, o, mode):
    shard = p.get("tp")
    if shard is None:
        return _proj(p, st, "to_out", o, o, o, mode)
    return _row_parallel(p["to_out"], None if st is None else
                         st.get("to_out"), o, mode, shard)


def _plain(pp) -> bool:
    return "lora" not in pp and "tlora" not in pp


def attention(p, x, ctx=None, *, heads: int, kv: Optional[Tuple] = None,
              mode: str = "base", state=None):
    """x: (N, S, C). ctx: None for self-attention, or a (combined,
    content, style) tuple of encoder states. kv: optional precomputed
    (k, v), each (Bk, Sk, inner); Bk may divide N by a frame-replication
    factor. state: this attention's UnZipLoRA state ({proj: entry}).
    heads: the config's head count; a model shard runs its own."""
    if "tp" in p:
        heads = p["tp"].heads
    if kv is not None:
        q = _proj(p, state, "to_q", x, x, x, mode)
        k, v = kv
        n = x.shape[0]
        if k.shape[0] != n:
            rep = n // k.shape[0]
            k = k.repeat_interleave(rep, dim=0)
            v = v.repeat_interleave(rep, dim=0)
        o = merge_heads(sdpa(split_heads(q, heads),
                             split_heads(k.to(q.dtype), heads),
                             split_heads(v.to(q.dtype), heads)))
        return _out(p, state, o, mode)
    if ctx is None and all(_plain(p[n]) for n in _QKV):
        o = sdpa_fused_qkv(fused_qkv_projection(p, x), heads)
        return _out(p, state, o, mode)
    q = _proj(p, state, "to_q", x, x, x, mode)
    if ctx is None:
        c = c_c = c_s = x
    else:
        c, c_c, c_s = ctx
        c_c = c if c_c is None else c_c
        c_s = c if c_s is None else c_s
    k = _proj(p, state, "to_k", c, c_c, c_s, mode)
    v = _proj(p, state, "to_v", c, c_c, c_s, mode)
    o = merge_heads(sdpa(split_heads(q, heads), split_heads(k, heads),
                         split_heads(v, heads)))
    return _out(p, state, o, mode)


def cross_attention_kv(p, ctx: Tuple, *, mode: str = "base", state=None):
    """The prompt-side k/v projections of one cross-attention, any LoRA
    branches included (loop invariant across denoise steps). ctx:
    (combined, content, style); state: this attention's UnZipLoRA state.
    Returns (k, v), each (B, Sk, inner)."""
    c, c_c, c_s = ctx
    c_c = c if c_c is None else c_c
    c_s = c if c_s is None else c_s
    k = _proj(p, state, "to_k", c, c_c, c_s, mode)
    v = _proj(p, state, "to_v", c, c_c, c_s, mode)
    return k, v


def init_feed_forward(ini, dim: int, *, mult: int = 4):
    """GEGLU MLP (diffusers FeedForward with GEGLU activation)."""
    inner = dim * mult
    return {"proj": layers.init_linear(ini, dim, inner * 2),
            "out": layers.init_linear(ini, inner, dim)}


def feed_forward(p, x):
    h = geglu_projection(x, p["proj"]["weight"].to(x.dtype),
                         p["proj"]["bias"].to(x.dtype))
    if "tp" in p:
        return _row_parallel(p["out"], None, h, "base", p["tp"])
    return layers.linear(p["out"], h)
