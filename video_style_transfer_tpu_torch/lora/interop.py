"""Reference-format LoRA artifact interop.

The reference's save format:

  <name>_content/  safetensors: unet.{module_path}.lora.up.weight (out, r)
                                unet.{module_path}.lora.down.weight (r, in)
  <name>_style/    the same keys for the style branch
  <name>_merger_content.pth / _merger_style.pth:
                   unet.{module_path}.lora.merge_{branch} -> (out,)

with the column gate folded into ``up``: the hard mask when the column
filter is active, else the merger. The per-branch safetensors are
diffusers-``load_lora_weights`` compatible, which is how the reference
does content-only and style-only generation.

This module converts both ways between that format (dicts of float32
numpy arrays) and the port's per-layer params and state trees. The
import functions return new trees that share every untouched leaf.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from video_style_transfer_tpu_torch.lora.surgery import (
    PROJS, iter_spatial_attention_paths, sub, tree_get, tree_replace,
    tree_set)
from video_style_transfer_tpu_torch.lora.unzip import init_unzip_lora_state


def _module_name(path, proj: str) -> str:
    """('down_blocks', 1, 'attentions', 0, 'transformer_blocks', 2,
    'attn1') + to_q -> 'down_blocks.1.attentions.0.transformer_blocks.2.
    attn1.to_q' ('to_out' is diffusers' 'to_out.0')."""
    return ".".join([str(k) for k in path]
                    + [proj if proj != "to_out" else "to_out.0"])


def iter_layer_modules(params):
    """Yields (path, proj, module_name) for every projection of every
    spatial attention layer."""
    for path in iter_spatial_attention_paths(params):
        for proj in PROJS:
            yield path, proj, _module_name(path, proj)


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def export_state_dicts(params, state, branch: str):
    """-> (lora_dict, merger_dict) of float32 numpy arrays in the
    reference key format and orientation (up (out, r), down (r, in))."""
    lora_sd: Dict[str, np.ndarray] = {}
    merger_sd: Dict[str, np.ndarray] = {}
    for path, proj, name in iter_layer_modules(params):
        p = tree_get(params, path)[proj]
        if "lora" not in p:
            continue
        lp = p["lora"]
        st = sub(state, *path, proj)
        down = _np32(lp[branch]["down"]).T   # (r, in)
        up = _np32(lp[branch]["up"]).T       # (out, r)
        merge = _np32(lp[f"merge_{branch}"])
        if st is not None and bool(st[f"use_mask_{branch}"]):
            gate = _np32(st[f"mask_{branch}"])
        else:
            gate = merge
        lora_sd[f"unet.{name}.lora.up.weight"] = up * gate[:, None]
        lora_sd[f"unet.{name}.lora.down.weight"] = down
        merger_sd[f"unet.{name}.lora.merge_{branch}"] = merge
    return lora_sd, merger_sd


def _check_depth(params, present: Dict[Tuple, set]):
    """Every transformer stack the artifact touches must be covered in
    full: a layer missing below a present one means a damaged file."""
    for (stack, attn, proj), layers in present.items():
        depth = len(tree_get(params, stack))
        if len(layers) != depth:
            raise ValueError(
                f"LoRA artifact covers {len(layers)} of {depth} layers for "
                f"stack {stack + (attn, proj)}")


def _install(params, staged: Dict[Tuple, Dict], dtype):
    state: Dict = {}
    new_params = params
    for ppath, lora in staged.items():
        dev = tree_get(params, ppath)["weight"].device
        def put(a):
            return torch.tensor(a, dtype=dtype, device=dev)
        lora = {k: ({kk: put(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else put(v))
                for k, v in lora.items()}
        new_params = tree_replace(new_params, ppath + ("lora",), lora)
        tree_set(state, ppath, init_unzip_lora_state(
            lora["merge_content"].shape[0], device=dev))
    return new_params, state


def import_state_dicts(params, content_sd: Dict, style_sd: Dict,
                       merger_content: Optional[Dict] = None,
                       merger_style: Optional[Dict] = None,
                       dtype=torch.float32):
    """Install reference-format LoRA dicts into a params tree (the
    inference path). Returns (params, lora_state).

    The reference quirk is kept: exported ``up`` weights already carry
    the mask-or-merger fold, and "both" mode multiplies the loaded merger
    in again, which is exactly the reference's inference math."""
    staged: Dict[Tuple, Dict] = {}
    present: Dict[Tuple, set] = {}
    for path, proj, name in iter_layer_modules(params):
        cu = content_sd.get(f"unet.{name}.lora.up.weight")
        cd = content_sd.get(f"unet.{name}.lora.down.weight")
        su = style_sd.get(f"unet.{name}.lora.up.weight")
        sd_ = style_sd.get(f"unet.{name}.lora.down.weight")
        have = [x is not None for x in (cu, cd, su, sd_)]
        if not any(have):
            continue
        if not all(have):
            raise ValueError(
                f"incomplete LoRA artifact for {name}: up/down must be "
                f"present in BOTH branch dicts (got content up/down="
                f"{have[0]}/{have[1]}, style={have[2]}/{have[3]})")
        mc = (merger_content or {}).get(f"unet.{name}.lora.merge_content")
        ms = (merger_style or {}).get(f"unet.{name}.lora.merge_style")
        out_f = np.asarray(cu).shape[0]
        ones = np.ones((out_f,), np.float32)
        staged[path + (proj,)] = {
            "content": {"down": _np32(cd).T, "up": _np32(cu).T},
            "style": {"down": _np32(sd_).T, "up": _np32(su).T},
            "merge_content": ones if mc is None else _np32(mc),
            "merge_style": ones if ms is None else _np32(ms),
        }
        present.setdefault((path[:-2], path[-1], proj), set()).add(path[-2])
    _check_depth(params, present)
    return _install(params, staged, dtype)


def import_single_lora(params, sd: Dict, *, branch: str = "content",
                       scale: float = 1.0, dtype=torch.float32):
    """Load ONE exported per-branch LoRA file into a base UNet: the chosen
    branch carries the adapter (scaled), the other branch is zero, the
    mergers are ones. Generate with mode "content" (or "style"), which
    skips the mergers, as the reference does for single-LoRA
    recontextualisation. Returns (params, lora_state)."""
    other = "style" if branch == "content" else "content"
    staged: Dict[Tuple, Dict] = {}
    for path, proj, name in iter_layer_modules(params):
        up = sd.get(f"unet.{name}.lora.up.weight")
        down = sd.get(f"unet.{name}.lora.down.weight")
        if up is None or down is None:
            continue
        up, down = _np32(up).T * np.float32(scale), _np32(down).T
        ones = np.ones((up.shape[1],), np.float32)
        staged[path + (proj,)] = {
            branch: {"down": down, "up": up},
            other: {"down": np.zeros_like(down), "up": np.zeros_like(up)},
            "merge_content": ones, "merge_style": ones.copy(),
        }
    return _install(params, staged, dtype)


# ---------------------------------------------------------------------------
# File IO: safetensors for the LoRA dicts, torch .pth for the mergers (the
# reference's on-disk formats)
# ---------------------------------------------------------------------------

def save_safetensors(sd: Dict[str, np.ndarray], path: str):
    from video_style_transfer_tpu_torch.utils import safetensors_io
    safetensors_io.save_file(sd, path)


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    from video_style_transfer_tpu_torch.utils import safetensors_io
    return safetensors_io.load_numpy(path)


def save_merger_pth(sd: Dict[str, np.ndarray], path: str):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)


def load_merger_pth(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in obj.items()}
