"""Reference-format training artifacts (resume and checkpoint rotation
are not ported yet)."""
from __future__ import annotations

import os


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
