"""Motion-weight bridge: diffusers MotionAdapter / UNetMotionModel state
dicts and the reference's ``motion_modules.pth`` <-> the motion modules
of the port's UNet params.

Both formats use one key namespace, which the params mirror:

  {down_blocks.{i}|mid_block|up_blocks.{i}}.motion_modules.{j}.
      {norm,proj_in,proj_out}.{weight,bias}
      transformer_blocks.{k}.{norm1,norm2,norm3}.{weight,bias}
      transformer_blocks.{k}.attn{1,2}.{to_q,to_k,to_v}.weight
      transformer_blocks.{k}.attn{1,2}.to_out.0.{weight,bias}
      transformer_blocks.{k}.ff.net.0.proj.{weight,bias}
      transformer_blocks.{k}.ff.net.2.{weight,bias}
      transformer_blocks.{k}.pos_embed.pe   (a persistent buffer of
          UNetMotionModel state dicts: the deterministic sinusoidal
          table, checked and dropped on import, recomputed on export)
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from video_style_transfer_tpu_torch.lora.surgery import (
    PROJS, iter_motion_attention_paths, tree_get, tree_replace)
from video_style_transfer_tpu_torch.lora.temporal import temporal_delta
from video_style_transfer_tpu_torch.utils.hf_convert import (
    convert_to_params, export_to_state_dict)


def _is_motion(path) -> bool:
    return "motion_modules" in path


def reference_pe_table(dim: int, max_len: int = 32) -> np.ndarray:
    """The diffusers SinusoidalPositionalEmbedding buffer, shape
    (1, max_len, dim)."""
    from video_style_transfer_tpu_torch.models.embeddings import (
        temporal_positional_encoding)
    return temporal_positional_encoding(max_len, dim,
                                        max_len=max_len).numpy()[None]


def import_motion_state_dict(unet_params, sd: Dict, *, dtype=None,
                             strict: bool = True):
    """Graft a motion-module state dict (MotionAdapter safetensors or a
    UNetMotionModel-derived ``motion_modules.pth``) into the UNet params;
    returns a new tree. Keys outside the motion modules are ignored;
    ``pos_embed.pe`` buffers are checked against the sinusoidal table and
    dropped. dtype defaults to the existing motion weights', so a bf16
    serving tree stays bf16."""
    motion_sd = {k: v for k, v in sd.items() if "motion_modules" in k}
    if not motion_sd:
        raise KeyError("state dict contains no 'motion_modules' keys")
    for k in [k for k in motion_sd if k.endswith("pos_embed.pe")]:
        pe = np.asarray(motion_sd.pop(k), np.float32)
        want = reference_pe_table(pe.shape[-1], pe.shape[-2])
        if not np.allclose(pe, want, atol=1e-4):
            raise ValueError(
                f"{k}: positional-encoding buffer does not match the "
                "sinusoidal table: the checkpoint was trained with a "
                "different PE scheme")
    probe = unet_params["down_blocks"][0]["motion_modules"][0]["proj_in"][
        "weight"]
    return convert_to_params(motion_sd, unet_params,
                             dtype=probe.dtype if dtype is None else dtype,
                             device=probe.device, strict=strict,
                             select=_is_motion)


def export_motion_state_dict(params, *, fold_tlora: bool = True,
                             include_pe: bool = True,
                             max_seq_length: int = 32
                             ) -> Dict[str, np.ndarray]:
    """Motion-module state dict in UNetMotionModel key naming, float32
    numpy. With fold_tlora the temporal-LoRA deltas are merged into the
    base weights (wrapper-free checkpoints); include_pe emits the
    ``pos_embed.pe`` buffers as ``unet.state_dict()`` would."""
    merged = fold_temporal_lora(params) if fold_tlora else params
    sd = export_to_state_dict(merged, select=_is_motion)
    if include_pe:
        for key in list(sd):
            m = re.fullmatch(r"(.*transformer_blocks\.\d+\.)norm1\.weight",
                             key)
            if m:
                sd[m.group(1) + "pos_embed.pe"] = reference_pe_table(
                    sd[key].shape[-1], max_seq_length)
    return sd


def fold_temporal_lora(params):
    """A new tree with every ``tlora`` delta folded into its base weight
    (the delta rounded to the weight's dtype, then added) and the
    adapters removed."""
    merged = params
    for apath in iter_motion_attention_paths(params):
        attn = tree_get(params, apath)
        for proj in PROJS:
            p = attn[proj]
            if "tlora" not in p:
                continue
            new_p = {k: v for k, v in p.items() if k != "tlora"}
            new_p["weight"] = (p["weight"].detach() + temporal_delta(
                p["tlora"]).detach().t().to(p["weight"].dtype))
            merged = tree_replace(merged, apath + (proj,), new_p)
    return merged


# ---------------------------------------------------------------------------
# File IO (.pth via torch, .safetensors via utils/safetensors_io.py)
# ---------------------------------------------------------------------------

def find_motion_checkpoint(path: str) -> Optional[str]:
    """A file, or ``motion_modules.pth`` / ``motion_modules.safetensors``
    inside a directory."""
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        for name in ("motion_modules.pth", "motion_modules.safetensors"):
            cand = os.path.join(path, name)
            if os.path.isfile(cand):
                return cand
    return None


def load_motion_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a motion checkpoint file or directory: ``.pth`` (torch, the
    reference's format) or ``.safetensors``."""
    found = find_motion_checkpoint(path)
    if found is None:
        raise FileNotFoundError(f"no motion checkpoint at {path}")
    if found.endswith(".pth"):
        sd = torch.load(found, map_location="cpu", weights_only=True)
        return {k: v.numpy() for k, v in sd.items()}
    from video_style_transfer_tpu_torch.utils import safetensors_io
    return safetensors_io.load_numpy(found)


def save_motion_checkpoint(sd: Dict[str, np.ndarray], path: str) -> str:
    """Write ``.pth`` (torch.save, loadable by the reference) or
    ``.safetensors``, by extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".pth"):
        torch.save({k: torch.from_numpy(np.array(v, np.float32, copy=True))
                    for k, v in sd.items()}, path)
        return path
    from video_style_transfer_tpu_torch.utils import safetensors_io
    return safetensors_io.save_file(sd, path)
