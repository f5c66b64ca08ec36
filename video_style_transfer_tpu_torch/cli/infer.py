"""Image inference CLI: the reference's four generation modes — combined
recontextualisation (both LoRAs and their mergers), content only, style
only, and base SDXL. Seeds default to the reference's fixed set
{0, 1000, 111, 1234}; 50 steps at CFG 5.

Without --pretrained_model_name_or_path it builds full-width SDXL with
seeded random weights and seeded prompt token ids; --smoke uses the tiny
configs (16^2, 2 steps, f32, a seeded rank-4 LoRA). ``generate(args)``
returns the images, ``main()`` also writes one png per image.

    python -m video_style_transfer_tpu_torch.cli.infer \\
        --pretrained_model_name_or_path sdxl/ \\
        --unziplora_name_or_path out/stage1 --prompt "a dog in watercolor" \\
        --prompt_content "a dog" --prompt_style "in watercolor" --mode both
"""
from __future__ import annotations

import argparse
import os

import torch

from video_style_transfer_tpu_torch.cli import common

# flag -> (value that means "unused", what it waits for)
NOT_PORTED = {
    "tp": (1, "multi-GPU serving"),
    "dp": (1, "multi-GPU serving"),
    "coordinator_address": (None, "multi-process serving"),
    "num_processes": (None, "multi-process serving"),
    "process_id": (None, "multi-process serving"),
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", default=None,
                   help="diffusers-layout SDXL directory")
    p.add_argument("--pretrained_vae_model_name_or_path", default=None,
                   help="separate VAE checkpoint directory (e.g. "
                        "sdxl-vae-fp16-fix)")
    p.add_argument("--unziplora_name_or_path", default=None,
                   help="stage-1 artifact directory")
    p.add_argument("--unziplora_name", default="unziplora")
    p.add_argument("--style_name_or_path", default=None,
                   help="cross-image generation: take the style branch "
                        "from another trained artifact set")
    p.add_argument("--style_name", default=None)
    p.add_argument("--single_lora", default=None,
                   help="load ONE per-branch LoRA safetensors file (plain "
                        "single-LoRA generation); forces --mode content")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--prompt", required=True)
    p.add_argument("--prompt_2", default=None,
                   help="separate text for the second (bigG) encoder")
    p.add_argument("--prompt_content", default=None)
    p.add_argument("--prompt_content_2", default=None)
    p.add_argument("--prompt_style", default=None)
    p.add_argument("--prompt_style_2", default=None)
    p.add_argument("--negative_prompt",
                   default=common.DEFAULT_NEGATIVE_PROMPT)
    p.add_argument("--negative_prompt_2", default=None)
    p.add_argument("--negative_prompt_content", default=None)
    p.add_argument("--negative_prompt_style", default=None)
    p.add_argument("--mode", default="both",
                   choices=["both", "content", "style", "base"])
    p.add_argument("--output_dir", "--save_dir", dest="output_dir",
                   default="out/images")
    p.add_argument("--num", type=int, default=1,
                   help="images per (prompt, seed)")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--height", type=int, default=None,
                   help="defaults to --resolution")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--sampler", default="euler", choices=["euler", "dpm"])
    p.add_argument("--vae_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="VAE decode dtype: float32 (default, the "
                        "reference's) or bfloat16 (fast decode)")
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[0, 1000, 111, 1234])
    p.add_argument("--tp", type=int, default=1, help="not ported yet")
    p.add_argument("--dp", type=int, default=1, help="not ported yet")
    p.add_argument("--coordinator_address", default=None,
                   help="not ported yet")
    p.add_argument("--num_processes", type=int, default=None,
                   help="not ported yet")
    p.add_argument("--process_id", type=int, default=None,
                   help="not ported yet")
    p.add_argument("--watermark", action="store_true",
                   help="stamp the SDXL invisible watermark "
                        "(utils/watermark.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    p.add_argument("--smoke", action="store_true",
                   help="tiny configs: 16^2, 2 steps, f32")
    p.add_argument("--config_preset", default="sdxl",
                   choices=["sdxl", "tiny"],
                   help="topology of the --pretrained_model_name_or_path "
                        "directory: sdxl (default), or tiny, the synthetic "
                        "checkpoint of cli/verify_parity.py (runs in f32)")
    return p


def load_lora(args, params, device):
    """(params, lora_state) for the requested mode, from the artifact
    flags; --smoke without artifacts draws a rank-4 LoRA. May change
    args.mode (--single_lora generates in content mode)."""
    from video_style_transfer_tpu_torch.lora import interop
    from video_style_transfer_tpu_torch.lora.surgery import (
        copy_structure, insert_unziplora)
    from video_style_transfer_tpu_torch.models.layers import Init

    if args.single_lora:
        args.mode = "content"
        return interop.import_single_lora(
            params, interop.load_safetensors(args.single_lora),
            scale=args.lora_scale)
    if args.mode == "base":
        return params, None
    if args.unziplora_name_or_path:
        base, name = args.unziplora_name_or_path, args.unziplora_name
        style_base = args.style_name_or_path or base
        style_name = args.style_name or name
        return common.load_unziplora(
            params, base=base, name=name,
            style_path=os.path.join(style_base, f"{style_name}_style"),
            style_weight_path=os.path.join(
                style_base, f"{style_name}_merger_style.pth"))
    return insert_unziplora(copy_structure(params), Init(0, device), rank=4)


def generate(args, report=None):
    """Generate --num images per seed; returns {name: (H, W, 3) uint8
    numpy}, name = "{mode}_seed{seed}[_{i}]". When `report` is a dict it
    receives weight_init_s (models and LoRA import), text_encode_s (the
    LoRA fold and the prompt encodings), n_folded, per image
    denoise_step_s (a list; the first step includes the cross-attention
    k/v precompute), decode_s and kernel_launches, and peak_memory_gib
    (after the weights are in place) on CUDA."""
    from video_style_transfer_tpu_torch.cli.infer_video import _Clock
    from video_style_transfer_tpu_torch.lora.surgery import fold_unziplora
    from video_style_transfer_tpu_torch.pipelines.image import (
        decode_images, generate_latents)

    if report is None:
        report = {}
    common.refuse_unported(args, NOT_PORTED)
    smoke = args.smoke
    if (args.mode != "base" and not smoke and not args.single_lora
            and not args.unziplora_name_or_path):
        raise SystemExit("--unziplora_name_or_path is required for LoRA "
                         "modes (use --mode base for plain SDXL)")
    device = common.resolve_device(args.device)
    tiny = smoke or args.config_preset == "tiny"
    dtype = torch.float32 if tiny else torch.bfloat16
    res = 16 if smoke else args.resolution
    height = res if smoke else (args.height or res)
    width = res if smoke else (args.width or res)
    steps = 2 if smoke else args.num_inference_steps

    outs = {}
    with torch.inference_mode():
        clock = _Clock(device)
        bundle = common.load_models(
            args.pretrained_model_name_or_path, smoke=smoke, motion=False,
            dtype=dtype, seed=0, device=device,
            vae_path=args.pretrained_vae_model_name_or_path,
            configs=(common.tiny_checkpoint_configs()
                     if args.config_preset == "tiny" else None))
        params, state = load_lora(args, bundle.unet, device)
        report["weight_init_s"] = clock.lap()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        report["n_folded"] = 0
        if state is not None:
            # distinct content/style prompts keep the cross-attention
            # k/v LoRA live; the other 10 of 12 projections fold
            shared = args.prompt_content is None and args.prompt_style is None
            params, report["n_folded"] = fold_unziplora(
                params, state, mode=args.mode, fold_cross_kv=shared)
        cond = common.make_conditioning(
            bundle, args.prompt, args.prompt_content, args.prompt_style,
            height=height, width=width, prompt_2=args.prompt_2,
            prompt_content_2=args.prompt_content_2,
            prompt_style_2=args.prompt_style_2)
        uncond = common.negative_conditioning(
            bundle, args.negative_prompt, height=height, width=width,
            negative_prompt_2=args.negative_prompt_2,
            negative_prompt_content=args.negative_prompt_content,
            negative_prompt_style=args.negative_prompt_style)
        report["text_encode_s"] = clock.lap()
        report["images"] = {}
        for seed in args.seeds:
            for i in range(max(args.num, 1)):
                # draw i of a seed has its own stream; draw 0 is the seed
                gen = common.seeded_generator(seed + 0x9E3779B1 * i)
                steps_s = []
                before = common.kernel_launch_counts()
                latents = generate_latents(
                    params, bundle.unet_cfg, uncond, cond, height=height,
                    width=width, batch=1, num_steps=steps,
                    cfg_scale=args.guidance_scale, sampler=args.sampler,
                    mode=args.mode, state=state, dtype=dtype,
                    vae_scale_factor=bundle.vae_scale_factor, device=device,
                    generator=gen,
                    on_step=lambda _: steps_s.append(clock.lap()))
                img = decode_images(
                    bundle.vae, bundle.vae_cfg, latents,
                    dtype=getattr(torch, args.vae_dtype), check_finite=True)
                name = (f"{args.mode}_seed{seed}"
                        + (f"_{i}" if args.num > 1 else ""))
                outs[name] = img[0].cpu().numpy()
                report["images"][name] = {
                    "denoise_step_s": steps_s, "decode_s": clock.lap(),
                    "kernel_launches": common.launches_since(before)}
        if device.type == "cuda":
            report["peak_memory_gib"] = (
                torch.cuda.max_memory_allocated(device) / 2 ** 30)
    if args.watermark:
        from video_style_transfer_tpu_torch.utils.watermark import (
            apply_watermark)
        outs = {k: apply_watermark(v) for k, v in outs.items()}
    return outs


def main(argv=None):
    from video_style_transfer_tpu_torch.data.video_io import save_image

    args = build_parser().parse_args(argv)
    outs = generate(args)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for name, img in outs.items():
        paths.append(save_image(img, os.path.join(args.output_dir,
                                                  f"{name}.png")))
        print("wrote", paths[-1])
    return paths


if __name__ == "__main__":
    main()
