"""Tensor parallelism over the grid's 'model' axis (the JAX package's
parallel/tensor.py): the Megatron split of the spatial transformers.

The JAX package gives each weight a sharding (``tp_spec``) and lets GSPMD
insert the collectives. Here each rank holds only its slices, calls its
kernels on them, and the one reduction of each row-parallel projection
is written out:

- ``to_q`` / ``to_k`` / ``to_v``, column-parallel: the rows of
  ``weight`` (and ``bias``) of this rank's heads, the heads split by
  ``mesh.split_counts`` (uneven where the model axis does not divide the
  head count: 10 heads over 4 ranks are 3, 3, 2, 2). Each rank attends
  over its own heads, so the flash kernel (K1) runs at the rank's head
  count;
- ``to_out``, row-parallel: the matching columns of ``weight``; the
  partial products are summed over the model group and the bias is added
  once, after the sum;
- ``ff.proj``: this rank's rows of the ``W_h`` half and the same rows of
  the ``W_g`` half, concatenated into one ``[W_h_r ; W_g_r]``, so that
  the GEGLU kernel (K2) takes the rank's weight unchanged and each rank
  holds matched (h, gate) column pairs (the JAX package shards the packed
  axis contiguously and GSPMD reshards around the gate). The columns
  split in units of 8, K2's constraint;
- ``ff.out``, row-parallel, as ``to_out``.

Live LoRA branches follow their base projection: on a column-parallel one
the ``up`` columns (``tlora``: ``b``), the mergers and every per-column
entry of the UnZipLoRA state are sliced; on a row-parallel one the
``down`` rows (``tlora``: ``a``), and the branch's partial output joins
the partial product before the sum. Motion modules, norms, convolutions,
``proj_in`` / ``proj_out`` and the embeddings stay whole.

A sliced attention or feed-forward carries its ``ModelShard`` under the
key ``"tp"`` (models/attention.py reads it); without one the models run
as they do in one process.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch

from video_style_transfer_tpu_torch.config import CROSS
from video_style_transfer_tpu_torch.lora.surgery import (
    sub, tree_get, tree_replace)
from video_style_transfer_tpu_torch.parallel import distributed
from video_style_transfer_tpu_torch.parallel.mesh import split_counts

_QKV = ("to_q", "to_k", "to_v")
# K2 needs each rank's GEGLU width a multiple of 8
FF_UNIT = 8


@dataclass(frozen=True)
class ModelShard:
    """One rank's part of a sliced attention or feed-forward: the model
    group, and for an attention the rank's head count."""
    group: Optional[object]
    heads: Optional[int] = None


def _levels(cfg) -> Iterator[Tuple[str, Optional[int], int]]:
    """(block kind, block index or None, heads) of every UNet level that
    holds spatial transformers."""
    n = len(cfg.block_out_channels)
    for i, t in enumerate(cfg.down_block_types):
        if t == CROSS:
            yield "down_blocks", i, cfg.num_attention_heads[i]
    yield "mid_block", None, cfg.num_attention_heads[-1]
    for i, t in enumerate(cfg.up_block_types):
        if t == CROSS:
            yield "up_blocks", i, cfg.num_attention_heads[n - 1 - i]


def max_tp(cfg) -> int:
    """The largest model axis the UNet takes: its smallest head count
    among the levels that hold transformers (SDXL: 10). A larger one
    would leave a rank without a head (GSPMD would pad)."""
    return min(h for _, _, h in _levels(cfg))


def check_tp(tp: int, cfg) -> None:
    if tp > max_tp(cfg):
        raise SystemExit(f"--tp {tp} exceeds the UNet's smallest head count "
                         f"{max_tp(cfg)}: every rank needs a head of every "
                         f"attention")


def _attentions(params, cfg) -> Iterator[Tuple[tuple, int]]:
    """(path of an attention, its heads) for attn1 and attn2 of every
    spatial transformer layer."""
    for kind, i, heads in _levels(cfg):
        block = params[kind] if i is None else params[kind][i]
        prefix = (kind,) if i is None else (kind, i)
        for j, t2d in enumerate(block.get("attentions", [])):
            for k in range(len(t2d["transformer_blocks"])):
                for name in ("attn1", "attn2"):
                    yield prefix + ("attentions", j, "transformer_blocks",
                                    k, name), heads


def _span(counts, index, unit=1) -> slice:
    start = sum(counts[:index]) * unit
    return slice(start, start + counts[index] * unit)


def _cols(t, s: slice, dim: int):
    """A copy of `t`'s slice `s` along `dim` (a copy, so that the whole
    tensor can be freed)."""
    return t.narrow(dim, s.start, s.stop - s.start).clone(
        memory_format=torch.contiguous_format)


def _head_rows(attn, heads: int, grid) -> Tuple[int, slice]:
    """(this rank's head count, its rows of q/k/v's output) of an
    attention of `heads` heads."""
    d = attn["to_q"]["weight"].shape[0] // heads
    counts = split_counts(heads, grid.model)
    return counts[grid.model_index], _span(counts, grid.model_index, d)


def _column_parallel(p, rows: slice):
    """A projection's rows `rows` of its output: weight, bias and its
    LoRA branches' output columns."""
    out = dict(p)
    out["weight"] = _cols(p["weight"], rows, 0)
    if "bias" in p:
        out["bias"] = _cols(p["bias"], rows, 0)
    if "lora" in p:
        lora = p["lora"]
        out["lora"] = {
            **{b: {"down": lora[b]["down"],
                   "up": _cols(lora[b]["up"], rows, 1)}
               for b in ("content", "style")},
            **{m: _cols(lora[m], rows, 0)
               for m in ("merge_content", "merge_style")}}
    if "tlora" in p:
        out["tlora"] = {**p["tlora"], "b": _cols(p["tlora"]["b"], rows, 1)}
    return out


def _row_parallel(p, cols: slice):
    """A projection's input columns `cols`: weight and its LoRA branches'
    input rows (the bias stays whole: it is added once, after the
    sum)."""
    out = dict(p)
    out["weight"] = _cols(p["weight"], cols, 1)
    if "lora" in p:
        lora = p["lora"]
        out["lora"] = {
            **lora, **{b: {"down": _cols(lora[b]["down"], cols, 0),
                           "up": lora[b]["up"]}
                       for b in ("content", "style")}}
    if "tlora" in p:
        out["tlora"] = {**p["tlora"], "a": _cols(p["tlora"]["a"], cols, 0)}
    return out


def _geglu_rows(p, rows: slice):
    """ff.proj: rows `rows` of each half, [W_h_r ; W_g_r]."""
    inner = p["weight"].shape[0] // 2
    def pair(t):
        return torch.cat([_cols(t, rows, 0),
                          _cols(t, slice(rows.start + inner,
                                         rows.stop + inner), 0)])
    return {**p, "weight": pair(p["weight"]), "bias": pair(p["bias"])}


def tp_shard(params, cfg, grid):
    """This rank's UNet param dict under tensor parallelism on `grid`'s
    model axis (see the module docstring). The input is left as it is;
    leaves that stay whole are shared."""
    check_tp(grid.model, cfg)
    out = params
    for path, heads in _attentions(params, cfg):
        attn = tree_get(params, path)
        mine, rows = _head_rows(attn, heads, grid)
        new = dict(attn)
        for name in _QKV:
            new[name] = _column_parallel(attn[name], rows)
        new["to_out"] = _row_parallel(attn["to_out"], rows)
        new["tp"] = ModelShard(grid.model_group, mine)
        out = tree_replace(out, path, new)
        if path[-1] == "attn2":
            ff_path = path[:-1] + ("ff",)
            ff = tree_get(params, ff_path)
            inner = ff["proj"]["weight"].shape[0] // 2
            units = split_counts(inner // FF_UNIT, grid.model)
            cols = _span(units, grid.model_index, FF_UNIT)
            out = tree_replace(out, ff_path, {
                "proj": _geglu_rows(ff["proj"], cols),
                "out": _row_parallel(ff["out"], cols),
                "tp": ModelShard(grid.model_group)})
    return out


def tp_shard_state(state, params, cfg, grid):
    """The UnZipLoRA state tree with every per-column entry of a
    column-parallel projection (``mask_*``, ``score_*``) cut to this
    rank's columns; `params` is the whole (unsliced) UNet tree the state
    belongs to. None stays None."""
    if state is None:
        return None
    out = state
    for path, heads in _attentions(params, cfg):
        _, rows = _head_rows(tree_get(params, path), heads, grid)
        for name in _QKV:
            entry = sub(state, *path, name)
            if entry is None:
                continue
            out = tree_replace(out, path + (name,), {
                k: (_cols(v, rows, 0) if v.dim() == 1 else v)
                for k, v in entry.items()})
    return out


def reduce_partial(y, shard: ModelShard):
    """The sum over the model group of a row-parallel projection's partial
    products; counts the payload in distributed.MODEL_REDUCED_BYTES."""
    distributed.MODEL_REDUCED_BYTES += y.numel() * y.element_size()
    return distributed.all_reduce_sum(y, shard.group)
