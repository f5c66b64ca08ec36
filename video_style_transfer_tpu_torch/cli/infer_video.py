"""Video inference CLI: AnimateDiff-XL video generation (plain
AnimateDiff, ``--modes base``). Defaults mirror the reference's
inference_animatediff.sh (16 frames, 1024^2, CFG 7.5, 30 steps).

Without --pretrained_model_name_or_path it builds full-width SDXL +
AnimateDiff-XL with seeded random weights and seeded prompt token ids;
--smoke uses the tiny configs. ``generate(args)`` returns the frames,
``main()`` also writes one video per mode.

    python -m video_style_transfer_tpu_torch.cli.infer_video \\
        --prompt "a horse" --modes base --device cuda
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
                   help="checkpoint directory (loading is not ported yet)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--negative_prompt",
                   default=common.DEFAULT_NEGATIVE_PROMPT)
    p.add_argument("--modes", nargs="+", default=["base"], choices=["base"],
                   help="plain AnimateDiff-XL; the UnZipLoRA modes "
                        "(both/content/style) need the LoRA fold, which is "
                        "not ported yet")
    p.add_argument("--output_dir", "--save_dir", dest="output_dir",
                   default="out/videos")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    p.add_argument("--smoke", action="store_true",
                   help="tiny configs: 4 frames at 16^2, 2 steps, f32 "
                        "(otherwise the UNet and CLIPs run in bf16 and the "
                        "VAE decodes in fp32)")
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
    seconds: weight_init_s, and per mode text_encode_s, denoise_step_s
    (a list) and decode_s."""
    from video_style_transfer_tpu_torch.pipelines.video import (
        decode_video, generate_video_latents)

    if report is None:
        report = {}
    device = common.resolve_device(args.device)
    smoke = args.smoke
    dtype = torch.float32 if smoke else torch.bfloat16
    res = 16 if smoke else args.resolution
    steps = 2 if smoke else args.num_inference_steps
    frames = 4 if smoke else args.num_frames

    outs = {}
    with torch.inference_mode():
        clock = _Clock(device)
        bundle = common.load_models(args.pretrained_model_name_or_path,
                                    smoke=smoke, motion=True, dtype=dtype,
                                    seed=0, device=device)
        report["weight_init_s"] = clock.lap()
        # the first mode's text_encode_s includes the negative prompt
        uncond = common.negative_conditioning(
            bundle, args.negative_prompt, height=res, width=res)
        for mode in args.modes:
            rep = report.setdefault(mode, {})
            cond = common.make_conditioning(bundle, args.prompt, height=res,
                                            width=res)
            rep["text_encode_s"] = clock.lap()
            gen = torch.Generator(device=device)
            gen.manual_seed(args.seed)
            steps_s = []
            latents = generate_video_latents(
                bundle.unet, bundle.unet_cfg, uncond, cond,
                num_frames=frames, height=res, width=res,
                num_steps=steps, cfg_scale=args.guidance_scale, dtype=dtype,
                vae_scale_factor=bundle.vae_scale_factor, device=device,
                generator=gen, on_step=lambda i: steps_s.append(clock.lap()))
            rep["denoise_step_s"] = steps_s
            video = decode_video(bundle.vae, bundle.vae_cfg, latents,
                                 chunk=frames if smoke else 1,
                                 check_finite=True)
            rep["decode_s"] = clock.lap()
            outs[mode] = video.cpu().numpy()
    return outs


def main(argv=None):
    from video_style_transfer_tpu_torch.data.video_io import save_video

    args = build_parser().parse_args(argv)
    outs = generate(args)
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
