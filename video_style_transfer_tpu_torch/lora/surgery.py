"""LoRA insertion and pairing over the port's param trees (the JAX
package's lora/surgery.py counterpart).

Params are nested dicts and per-layer lists, so every path here names the
layer: (..., "attentions", j, "transformer_blocks", k, "attn1"). The
insert functions add ``lora`` / ``tlora`` entries to the projection
dicts in place and return the tree; ``fold_unziplora`` and the state
utilities return new trees that share every untouched leaf and leave
their input as it was. The UnZipLoRA state mirrors the params with dicts
only (integer keys for block, attention and layer indices), as the JAX
state tree does.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import torch

from video_style_transfer_tpu_torch.lora.temporal import init_temporal_lora
from video_style_transfer_tpu_torch.lora.unzip import (
    folded_delta, init_unzip_lora_params, init_unzip_lora_state)

PROJS = ("to_q", "to_k", "to_v", "to_out")
Path = Tuple


def tree_get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree: Dict, path: Path, value):
    """In-place set into a tree of dicts; missing keys along the path are
    created."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
    return value


def copy_structure(tree):
    """New dicts and lists around the same leaves: in-place edits of the
    copy's structure leave the original as it was."""
    if isinstance(tree, dict):
        return {k: copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_structure(v) for v in tree]
    return tree


def tree_replace(tree, path: Path, value):
    """The tree with `value` at `path`: dicts and lists along the path
    are shallow-copied, everything else is shared, the input is left
    unchanged. Missing trailing dict keys are created."""
    if not path:
        return value
    k = path[0]
    if isinstance(tree, list):
        new = list(tree)
        child = tree[k]
    else:
        new = dict(tree)
        child = tree.get(k, {})
    new[k] = tree_replace(child, path[1:], value)
    return new


def sub(state, *path):
    """Index a (possibly missing) state tree of dicts: None where a key is
    absent."""
    for k in path:
        if state is None:
            return None
        state = state.get(k)
    return state


def _blocks(unet_params):
    for kind in ("down_blocks", "mid_block", "up_blocks"):
        if kind == "mid_block":
            yield ("mid_block",), unet_params["mid_block"]
        else:
            for i, b in enumerate(unet_params.get(kind, [])):
                yield (kind, i), b


def _attention_paths(unet_params, group: str) -> Iterator[Path]:
    for prefix, block in _blocks(unet_params):
        for j, mod in enumerate(block.get(group, [])):
            for k in range(len(mod["transformer_blocks"])):
                for name in ("attn1", "attn2"):
                    yield prefix + (group, j, "transformer_blocks", k, name)


def iter_spatial_attention_paths(unet_params) -> Iterator[Path]:
    """Every spatial attention (attn1 and attn2 of every layer of every
    cross-attention block); motion modules excluded."""
    return _attention_paths(unet_params, "attentions")


def iter_motion_attention_paths(unet_params) -> Iterator[Path]:
    """Every temporal attention (attn1 and attn2 of every motion
    block)."""
    return _attention_paths(unet_params, "motion_modules")


def path_str(path: Path) -> str:
    return ".".join(str(k) for k in path)


def insert_unziplora(unet_params, ini, *, rank: int = 64, dtype=None):
    """Give every q/k/v/out projection of every spatial attention a
    ``lora`` entry drawn from ``ini``. Returns (params, lora_state)."""
    dtype = torch.float32 if dtype is None else dtype
    state: Dict = {}
    for path in iter_spatial_attention_paths(unet_params):
        attn = tree_get(unet_params, path)
        for proj in PROJS:
            out_f, in_f = attn[proj]["weight"].shape
            attn[proj]["lora"] = init_unzip_lora_params(
                ini, in_f, out_f, rank=rank, dtype=dtype)
            tree_set(state, path + (proj,),
                     init_unzip_lora_state(out_f, device=ini.device))
    return unet_params, state


def insert_temporal_lora(unet_params, ini, *, rank: int = 32,
                         alpha: float = 1.0, dtype=None):
    """Give every motion-module q/k/v/out projection a ``tlora``
    entry."""
    dtype = torch.float32 if dtype is None else dtype
    for path in iter_motion_attention_paths(unet_params):
        attn = tree_get(unet_params, path)
        for proj in PROJS:
            out_f, in_f = attn[proj]["weight"].shape
            attn[proj]["tlora"] = init_temporal_lora(
                ini, in_f, out_f, rank=rank, alpha=alpha, dtype=dtype)
    return unet_params


def spatial_pairs(unet_params) -> List[Tuple[Path, Path]]:
    """Pair each temporal-LoRA projection with the spatial UnZipLoRA
    projection of the same block, attention group j, layer k and
    attention name (the reference's build_spatial_lora_index). attn2's
    cross-attention k/v (prompt-width inputs) drop out by the shape
    check, as there. Returns (tlora_path, lora_path) per layer."""
    pairs = []
    for mpath in iter_motion_attention_paths(unet_params):
        # (..., "motion_modules", j, "transformer_blocks", k, attn)
        j, k, name = mpath[-4], mpath[-2], mpath[-1]
        spath = mpath[:-5] + ("attentions", j, "transformer_blocks", k, name)
        try:
            sp = tree_get(unet_params, spath)
        except (KeyError, IndexError, TypeError):
            continue
        mp = tree_get(unet_params, mpath)
        for proj in PROJS:
            if proj not in sp or "lora" not in sp[proj]:
                continue
            if "tlora" not in mp[proj]:
                continue
            if sp[proj]["weight"].shape == mp[proj]["weight"].shape:
                pairs.append((mpath + (proj, "tlora"),
                              spath + (proj, "lora")))
    return pairs


def iter_lora_state_paths(state) -> Iterator[Path]:
    """Paths of all projection-level entries of a lora state tree."""
    def walk(node, path):
        if isinstance(node, dict):
            if "mask_content" in node:
                yield path
            else:
                for k, v in node.items():
                    yield from walk(v, path + (k,))
    yield from walk(state, ())


def map_lora_state(state, fn: Callable):
    """fn(path, entry) -> new entry, applied to every projection entry;
    returns a new state tree that shares the unchanged entries."""
    new = state
    for path in iter_lora_state_paths(state):
        entry = tree_get(state, path)
        updated = fn(path, entry)
        if updated is not entry:
            new = tree_replace(new, path, updated)
    return new


def set_branch_gates(state, off_paths: set, branch: str):
    """Inference block separation: switch a whole branch off at the given
    projection paths."""
    def fn(path, entry):
        if path in off_paths:
            e = dict(entry)
            e[f"on_{branch}"] = torch.zeros_like(entry[f"on_{branch}"])
            return e
        return entry
    return map_lora_state(state, fn)


def fold_unziplora(unet_params, lora_state, *, mode: str = "both",
                   fold_cross_kv: bool = False):
    """Serving-time LoRA folding: wherever the content and style input
    streams are the same tensor (self-attention entirely; cross-attention
    q and out, which take hidden states; cross-attention k/v only when
    the pipeline feeds one shared prompt, fold_cross_kv), add the fully
    gated delta to the base weight and drop the ``lora`` entry. The other
    projections keep their dynamic LoRA. The sum is taken in f32 and cast
    back to the weight's dtype.

    Returns (params, n_folded): a new tree that shares every untouched
    leaf (the input is unchanged, so one loaded tree serves every mode),
    and the number of projections folded."""
    params = unet_params
    n = 0
    for path in iter_spatial_attention_paths(unet_params):
        is_cross = path[-1] == "attn2"
        attn = tree_get(unet_params, path)
        for proj in PROJS:
            p = attn[proj]
            if "lora" not in p:
                continue
            if is_cross and proj in ("to_k", "to_v") and not fold_cross_kv:
                continue
            delta = folded_delta(p["lora"], sub(lora_state, *path, proj),
                                 mode=mode)
            new_p = {k: v for k, v in p.items() if k != "lora"}
            new_p["weight"] = (p["weight"].float()
                               + delta.t()).to(p["weight"].dtype)
            params = tree_replace(params, path + (proj,), new_p)
            n += 1
    return params, n
