"""Training checkpoints with resume, and the reference-format artifacts.

- save_checkpoint / restore_checkpoint: what a resumed run cannot rebuild
  from its flags (the trainable tensors by path, the optimizer's kind and
  state, the step), as ``torch.save`` of CPU tensors in
  ``<ckpt_dir>/checkpoint-<step>/state.pt``, read back with
  ``torch.load(weights_only=True)``. A checkpoint is written under a
  temporary name and committed by one ``os.replace``; only then are the
  oldest pruned down to ``total_limit``, the new one counted. A kill at
  any point leaves the previous checkpoint whole, and latest_checkpoint
  never sees an uncommitted directory (its name does not match
  ``checkpoint-<digits>``). A restore checks every path, shape, dtype and
  the optimizer's kind before it copies anything in. Stage 1 adds its
  LoRA state tree (masks, scores, use-mask flags) and its orth_on /
  merger_on flags as ``extra``.
- export_stage1_artifacts: the reference's four stage-1 artifacts;
- export_motion_checkpoint: the stage-2 motion-module weights with the
  temporal LoRA folded in.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

STATE_FILE = "state.pt"
_NAME = re.compile(r"checkpoint-\d+")


def path_key(path) -> str:
    """A tree path (keys and list indices) as one string."""
    return "/".join(map(str, path))


def train_state(trainable, optimizer, step: int, extra=None) -> dict:
    """The checkpoint of a trainer: {"step", "optimizer" (its kind),
    "optimizer_state", "trainable" {path: tensor}}, CPU copies; with
    `extra` (a tree of dicts, lists and tensors: stage 1's LoRA state and
    flags) also "extra", its CPU copy."""
    from video_style_transfer_tpu_torch.training.stage2 import _to_cpu
    state = {"step": int(step), "optimizer": optimizer.kind,
             "optimizer_state": optimizer.state_dict(),
             "trainable": {path_key(p): t.detach().to("cpu", copy=True)
                           for p, t in trainable}}
    if extra is not None:
        state["extra"] = _to_cpu(extra)
    return state


def _committed(ckpt_dir: str):
    """The committed checkpoint names under ckpt_dir, oldest first."""
    return sorted((d for d in os.listdir(ckpt_dir) if _NAME.fullmatch(d)),
                  key=lambda d: int(d.split("-")[1]))


def save_checkpoint(ckpt_dir: str, state: dict, step: int, *,
                    total_limit: Optional[int] = None) -> str:
    """Write <ckpt_dir>/checkpoint-<step> (committed before any older one
    is pruned) and keep the newest `total_limit`, the new one counted.
    Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"checkpoint-{step}"))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    if total_limit is not None:
        existing = _committed(ckpt_dir)
        while len(existing) > total_limit:
            shutil.rmtree(os.path.join(ckpt_dir, existing.pop(0)))
    return path


def save_checkpoint_main_process(ckpt_dir: str, state, step: int, *,
                                 total_limit: Optional[int] = None) -> str:
    """save_checkpoint on process 0 alone, then every process meets at a
    barrier ('checkpoint-saved'), so none runs ahead into the next step's
    collectives while process 0 writes, and a checkpoint is whole on
    disk before any process can resume from it. `state`: the dict, or a
    callable that builds it (called on process 0 only: the other
    processes make no CPU copies). Returns the checkpoint's path on
    every process. Every process resumes from that path, so a
    multi-host run needs an output directory all hosts share."""
    from video_style_transfer_tpu_torch.parallel import distributed
    path = os.path.abspath(os.path.join(ckpt_dir, f"checkpoint-{step}"))
    if distributed.is_main_process():
        path = save_checkpoint(ckpt_dir, state() if callable(state)
                               else state, step, total_limit=total_limit)
    distributed.barrier("checkpoint-saved")
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest committed checkpoint under ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = _committed(ckpt_dir)
    return os.path.abspath(os.path.join(ckpt_dir, names[-1])) if names \
        else None


def restore_checkpoint(path: str, trainable, optimizer, extra=None) -> int:
    """Load the checkpoint at `path` into the trainable tensors
    [(path, tensor)] and the optimizer (and, given `extra`, the live tree
    train_state saved as "extra"); returns its step. Raises ValueError,
    having changed nothing, where the trainable paths, shapes or dtypes,
    the optimizer's kind or state, or the extra tree's structure
    differ."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    if state["optimizer"] != optimizer.kind:
        raise ValueError(f"{path}: optimizer {state['optimizer']!r}, this "
                         f"run's is {optimizer.kind!r}")
    live = {path_key(p): t for p, t in trainable}
    saved = state["trainable"]
    if set(saved) != set(live):
        missing = sorted(set(live) - set(saved))
        extra = sorted(set(saved) - set(live))
        raise ValueError(f"{path}: trainable tensors differ (missing "
                         f"{missing[:3]}, unexpected {extra[:3]})")
    from video_style_transfer_tpu_torch.training.stage2 import (
        check_state_like, copy_state)
    check_state_like(saved, live, f"{path}: trainable")
    if extra is not None:
        if "extra" not in state:
            raise ValueError(f"{path}: holds no trainer state beside the "
                             f"optimizer's")
        check_state_like(state["extra"], extra, f"{path}: extra")
    # checks its state before it copies any of it in
    optimizer.load_state_dict(state["optimizer_state"])
    with torch.no_grad():
        copy_state(live, saved)
        if extra is not None:
            copy_state(extra, state["extra"])
    return int(state["step"])


def export_stage1_artifacts(out_dir: str, name: str, params, lora_state):
    """Write the reference's stage-1 artifact set:
      {name}_content/pytorch_lora_weights.safetensors
      {name}_style/pytorch_lora_weights.safetensors
      {name}_merger_content.pth / {name}_merger_style.pth
    Returns {branch: file, "merger_" + branch: file}."""
    from video_style_transfer_tpu_torch.lora import interop

    paths = {}
    for branch in ("content", "style"):
        lora_sd, merger_sd = interop.export_state_dicts(params, lora_state,
                                                        branch)
        d = os.path.join(out_dir, f"{name}_{branch}")
        os.makedirs(d, exist_ok=True)
        paths[branch] = os.path.join(d, "pytorch_lora_weights.safetensors")
        interop.save_safetensors(lora_sd, paths[branch])
        paths[f"merger_{branch}"] = os.path.join(
            out_dir, f"{name}_merger_{branch}.pth")
        interop.save_merger_pth(merger_sd, paths[f"merger_{branch}"])
    return paths


def export_motion_checkpoint(out_path: str, params):
    """Stage-2 checkpoint: every motion-module weight with the temporal
    LoRA delta folded into the base weights (wrapper-free inference), in
    diffusers UNetMotionModel key naming. Format by extension: ``.pth``
    is the reference's torch format (with the pos_embed.pe buffers),
    anything else safetensors. Returns the state dict written."""
    from video_style_transfer_tpu_torch.utils.motion_convert import (
        export_motion_state_dict, save_motion_checkpoint)

    sd = export_motion_state_dict(params,
                                  include_pe=out_path.endswith(".pth"))
    save_motion_checkpoint(sd, out_path)
    return sd
