"""LoRA insertion and pairing over the port's param trees, and stage 1's
block-separation tables and their grammar (the JAX package's
lora/surgery.py counterpart).

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

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from video_style_transfer_tpu_torch.lora.temporal import init_temporal_lora
from video_style_transfer_tpu_torch.utils import tracing
from video_style_transfer_tpu_torch.lora.unzip import (
    folded_delta, init_unzip_lora_params, init_unzip_lora_state)

PROJS = ("to_q", "to_k", "to_v", "to_out")
Path = Tuple

# The reference's published block-separation recipe for stage 1
# (``--with_freeze_unet``), in the grammar of expand_block_patterns
FREEZE_UNET_CONTENT = {"mid_block": ["N_0_A_A"],
                       "up_blocks.": ["1_A_A_A", "0_1_A_A"],
                       "down_blocks.": ["A_A_A_A"]}
FREEZE_UNET_STYLE = {"mid_block": ["N_0_A_A"],
                     "up_blocks.": ["0_0,2_A_A"],
                     "down_blocks.": ["A_A_A_A"]}


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
    and the number of projections folded (the ``fold`` span's
    ``projections``)."""
    params = unet_params
    n = 0
    with tracing.span("fold") as sp:
        for path in iter_spatial_attention_paths(unet_params):
            is_cross = path[-1] == "attn2"
            attn = tree_get(unet_params, path)
            for proj in PROJS:
                p = attn[proj]
                if "lora" not in p:
                    continue
                if is_cross and proj in ("to_k", "to_v") \
                        and not fold_cross_kv:
                    continue
                delta = folded_delta(p["lora"],
                                     sub(lora_state, *path, proj), mode=mode)
                new_p = {k: v for k, v in p.items() if k != "lora"}
                new_p["weight"] = (p["weight"].float()
                                   + delta.t()).to(p["weight"].dtype)
                params = tree_replace(params, path + (proj,), new_p)
                n += 1
        if sp is not None:
            sp.attrs = {"projections": n}
    return params, n


def expand_block_patterns(mask_dictionary: Dict[str, Sequence[str]], *,
                          num_down_blocks: int = 3, num_up_blocks: int = 3,
                          layers_per_block: int = 2) -> set:
    """Expand the reference's "{blocks}_{groups}_{attns}_{projs}" grammar
    into a set of (block_kind, block_idx, group_idx, attn_name, proj)
    tuples. Per pattern element:
      blocks: "N" (mid: no index) | "A" (SDXL's attention-bearing blocks:
              up 0, 1 / down 1, 2) | "0,1"
      groups: "A" (every attention group of the block) | "0,2"
      attns:  "A" (attn1 and attn2) | "1" | "2"
      projs:  "A" (q, k, v, out) | "q,k" ...
    num_down_blocks and num_up_blocks are accepted for the JAX
    signature; "A" names SDXL's blocks whatever they say."""
    out = set()
    for key, patterns in mask_dictionary.items():
        kind = key.rstrip(".")
        for pattern in patterns:
            nums, groups, attns, projs = pattern.split("_")
            if nums == "N":
                block_ids = [None]
            elif nums == "A":
                block_ids = [0, 1] if kind == "up_blocks" else [1, 2]
            else:
                block_ids = [int(x) for x in nums.split(",")]
            if groups == "A":
                n = layers_per_block + (kind == "up_blocks")
                group_ids = list(range(n))
            else:
                group_ids = [int(x) for x in groups.split(",")]
            attn_names = (["attn1", "attn2"] if attns == "A"
                          else [f"attn{x}" for x in attns.split(",")])
            proj_names = (list(PROJS) if projs == "A"
                          else [f"to_{x}" for x in projs.split(",")])
            for bi in block_ids:
                for gi in group_ids:
                    for an in attn_names:
                        for pn in proj_names:
                            out.add((kind, bi, gi, an, pn))
    return out


def selection_matches(path: Path, proj: str, selections: set) -> bool:
    """Does (attention path, projection) fall in an expanded selection?
    A path is per layer, (kind, [block,] "attentions", group,
    "transformer_blocks", layer, attn): every layer of a group shares its
    group's selection."""
    i = path.index("attentions")
    kind = path[0]
    block = None if kind == "mid_block" else path[1]
    return (kind, block, path[i + 1], path[-1], proj) in selections


def layer_assignments(unet_params, mask_dictionary_content: Dict,
                      mask_dictionary_style: Dict,
                      **expand_kw) -> Dict[Path, Optional[str]]:
    """Column-separation assignment of each (attention path, proj), per
    layer: "both" where both dictionaries (or neither) select it (both
    branches get sparse column masks), "style" where only the style one
    does (style sparse, content all on), "content" where only the
    content one does."""
    sel_c = expand_block_patterns(mask_dictionary_content, **expand_kw)
    sel_s = expand_block_patterns(mask_dictionary_style, **expand_kw)
    out: Dict[Path, Optional[str]] = {}
    for path in iter_spatial_attention_paths(unet_params):
        for proj in PROJS:
            in_c = selection_matches(path, proj, sel_c)
            in_s = selection_matches(path, proj, sel_s)
            if in_s and not in_c:
                label = "style"
            elif in_c and not in_s:
                label = "content"
            else:
                label = "both"
            out[path + (proj,)] = label
    return out
