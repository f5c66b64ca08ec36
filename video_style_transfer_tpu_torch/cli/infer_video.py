"""Video inference CLI: the reference's three-mode video generation —
the motion UNet, a stage-2 motion checkpoint and the stage-1 UnZipLoRA
artifacts, generating both / content / style videos (and base, plain
AnimateDiff-XL). Defaults mirror the reference's inference_animatediff.sh
(16 frames, 1024^2, CFG 7.5, 30 steps).

Without --pretrained_model_name_or_path it builds full-width SDXL +
AnimateDiff-XL with seeded random weights and seeded prompt token ids;
--smoke uses the tiny configs and, without artifacts, a seeded rank-4
LoRA. ``generate(args)`` returns the frames, ``main()`` also writes one
video per mode.

--frame_parallel N serves each video on N processes (torchrun
--nproc_per_node N, or --coordinator_address / --num_processes /
--process_id on each): each holds a contiguous run of the frames, with
both CFG rows, exchanges frames with the others only in the motion
modules, decodes its own frames, and process 0 writes the videos.

    python -m video_style_transfer_tpu_torch.cli.infer_video \\
        --pretrained_model_name_or_path sdxl/ \\
        --motion_checkpoint out/animatediff \\
        --unziplora_name_or_path out/stage1 --prompt "a horse" \\
        --modes both content style --device cuda
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from video_style_transfer_tpu_torch.cli import common


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", default=None,
                   help="diffusers-layout SDXL directory")
    p.add_argument("--motion_checkpoint", "--motion_adapter_path",
                   dest="motion_checkpoint", default=None,
                   help="motion weights: a stage-2 motion_modules.pth / "
                        ".safetensors (or a directory holding one), or a "
                        "diffusers MotionAdapter safetensors file")
    p.add_argument("--unziplora_name_or_path", default=None,
                   help="stage-1 artifact directory")
    p.add_argument("--unziplora_name", default="unziplora")
    # explicit per-artifact paths, the reference's spelling
    p.add_argument("--unziplora_content_path", default=None)
    p.add_argument("--unziplora_style_path", default=None)
    p.add_argument("--unziplora_content_weight_path", default=None)
    p.add_argument("--unziplora_style_weight_path", default=None)
    p.add_argument("--prompt", default=None)
    p.add_argument("--instance_prompt", default=None,
                   help="reference spelling for --prompt")
    p.add_argument("--content_prompt", default=None,
                   help="prompt of the content-only mode (defaults to "
                        "--prompt)")
    p.add_argument("--style_prompt", default=None,
                   help="prompt of the style-only mode (defaults to "
                        "--prompt)")
    p.add_argument("--negative_prompt",
                   default=common.DEFAULT_NEGATIVE_PROMPT)
    p.add_argument("--modes", nargs="+",
                   default=["both", "content", "style"],
                   choices=["both", "content", "style", "base"])
    p.add_argument("--output_dir", "--save_dir", dest="output_dir",
                   default="out/videos")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--height", type=int, default=None,
                   help="defaults to --resolution")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["no", "bf16", "fp16"],
                   help="UNet dtype; fp16 maps to bf16; the VAE decode "
                        "dtype is --vae_dtype")
    p.add_argument("--vae_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="VAE decode dtype: float32 (default, the "
                        "reference's) or bfloat16 (fast decode)")
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--frame_parallel", type=int, default=1,
                   help="split each video's frames over N processes, one "
                        "a GPU: spatial layers and the sampler run on each "
                        "process's own frames, the motion modules exchange "
                        "frames (one all-to-all pair a module), and each "
                        "process decodes its own frames. A frame count N "
                        "does not divide is served with uneven runs")
    common.add_distributed_flags(p, "serving run")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    p.add_argument("--smoke", action="store_true",
                   help="tiny configs: 4 frames at 16^2, 2 steps, f32")
    p.add_argument("--config_preset", default="sdxl",
                   choices=["sdxl", "tiny"],
                   help="topology of the --pretrained_model_name_or_path "
                        "directory: sdxl (default), or tiny, the synthetic "
                        "checkpoint of cli/verify_parity.py")
    return p


class _Clock:
    """Host seconds of phases that end in a device synchronise."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def lap(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


def generate(args, report=None):
    """Run the video pipeline for every mode; returns {mode: (F, H, W, 3)
    uint8 numpy frames}. When `report` is a dict it receives the phase
    seconds: weight_init_s (models, motion checkpoint and LoRA import),
    and per mode text_encode_s, fold_s and n_folded (the LoRA fold),
    denoise_step_s (a list), decode_s, kernel_launches (this process's),
    frame_range (this process's frames) and latents (its denoised
    latents before the decode, on the CPU). Under --frame_parallel
    every process returns the whole video."""
    from video_style_transfer_tpu_torch.lora.surgery import (
        copy_structure, fold_unziplora, insert_unziplora)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.pipelines.video import (
        decode_video, decode_video_frame_sharded, generate_video_latents)

    if report is None:
        report = {}
    prompt = args.prompt or args.instance_prompt
    if not prompt:
        raise SystemExit("need --prompt (or --instance_prompt)")
    smoke = args.smoke
    artifacts = bool(args.unziplora_name_or_path or (
        args.unziplora_content_path and args.unziplora_style_path))
    if not (artifacts or smoke) and any(m != "base" for m in args.modes):
        # the LoRA factors are not zero-initialised: folding random ones
        # into real weights would corrupt every frame
        raise SystemExit("--unziplora_name_or_path is required for LoRA "
                         "modes (use --modes base for plain AnimateDiff "
                         "generation)")
    fp = max(args.frame_parallel, 1)
    device, grid = common.setup_distributed(
        args, frame=fp, what=f"--frame_parallel {fp}")
    dtype = (torch.float32 if smoke or args.mixed_precision == "no"
             else torch.bfloat16)
    res = 16 if smoke else args.resolution
    height = res if smoke else (args.height or res)
    width = res if smoke else (args.width or res)
    steps = 2 if smoke else args.num_inference_steps
    frames = 4 if smoke else args.num_frames
    shard = grid.frame_shard(frames)
    if shard is not None and not shard.even and grid.rank == 0:
        print(f"note: --num_frames {frames} over --frame_parallel {fp}: "
              f"runs of {shard.counts} frames; the motion modules gather "
              f"the whole clip", flush=True)
    mode_prompts = {"both": prompt, "base": prompt,
                    "content": args.content_prompt or prompt,
                    "style": args.style_prompt or prompt}

    outs = {}
    with torch.inference_mode():
        clock = _Clock(device)
        bundle = common.load_models(
            args.pretrained_model_name_or_path, smoke=smoke, motion=True,
            dtype=dtype, seed=0, device=device,
            configs=(common.tiny_checkpoint_configs(motion=True)
                     if args.config_preset == "tiny" else None))
        base_params = bundle.unet
        if args.motion_checkpoint:
            from video_style_transfer_tpu_torch.utils.motion_convert import (
                import_motion_state_dict, load_motion_checkpoint)
            base_params = import_motion_state_dict(
                base_params, load_motion_checkpoint(args.motion_checkpoint))
        # "base" serves the tree without any LoRA entry
        params, state = base_params, None
        if artifacts:
            params, state = common.load_unziplora(
                base_params, base=args.unziplora_name_or_path,
                name=args.unziplora_name,
                content_path=args.unziplora_content_path,
                style_path=args.unziplora_style_path,
                content_weight_path=args.unziplora_content_weight_path,
                style_weight_path=args.unziplora_style_weight_path)
        elif smoke:
            params, state = insert_unziplora(copy_structure(base_params),
                                             Init(0, device), rank=4)
        report["weight_init_s"] = clock.lap()
        # the first mode's text_encode_s includes the negative prompt
        uncond = common.negative_conditioning(
            bundle, args.negative_prompt, height=height, width=width)
        for mode in args.modes:
            rep = report.setdefault(mode, {})
            cond = common.make_conditioning(bundle, mode_prompts[mode],
                                            height=height, width=width)
            rep["text_encode_s"] = clock.lap()
            # video inference feeds one shared prompt, so every LoRA
            # folds into the base weights and no branch is left to run
            fparams, rep["n_folded"] = base_params, 0
            if state is not None and mode != "base":
                fparams, rep["n_folded"] = fold_unziplora(
                    params, state, mode=mode, fold_cross_kv=True)
            rep["fold_s"] = clock.lap()
            gen = common.seeded_generator(args.seed)
            steps_s = []
            before = common.kernel_launch_counts()
            latents = generate_video_latents(
                fparams, bundle.unet_cfg, uncond, cond,
                num_frames=frames, height=height, width=width,
                num_steps=steps, cfg_scale=args.guidance_scale, mode=mode,
                state=state, dtype=dtype,
                vae_scale_factor=bundle.vae_scale_factor, device=device,
                generator=gen, on_step=lambda i: steps_s.append(clock.lap()),
                frame_shard=shard)
            del fparams
            rep["denoise_step_s"] = steps_s
            rep["frame_range"] = ((0, frames) if shard is None else
                                  (shard.start, shard.start + shard.local))
            rep["latents"] = latents.float().cpu()
            vae_dtype = getattr(torch, args.vae_dtype)
            if shard is None:
                video = decode_video(bundle.vae, bundle.vae_cfg, latents,
                                     chunk=frames if smoke else 1,
                                     dtype=vae_dtype, check_finite=True)
            else:
                video = decode_video_frame_sharded(
                    bundle.vae, bundle.vae_cfg, latents, shard,
                    dtype=vae_dtype, check_finite=True)
            rep["decode_s"] = clock.lap()
            rep["kernel_launches"] = common.launches_since(before)
            outs[mode] = video.cpu().numpy()
    return outs


def main(argv=None):
    from video_style_transfer_tpu_torch.data.video_io import save_video
    from video_style_transfer_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    outs = generate(args)
    if not distributed.is_main_process():
        return []
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for mode, video in outs.items():
        path = save_video(list(video),
                          os.path.join(args.output_dir, f"{mode}.mp4"),
                          fps=args.fps)
        paths.append(path)
        print("wrote", path)
    return paths


if __name__ == "__main__":
    main()
