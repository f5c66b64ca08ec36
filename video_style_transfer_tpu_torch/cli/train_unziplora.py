"""Stage-1 CLI: joint content/style UnZipLoRA training on SDXL (the JAX
package's cli/train_unziplora.py, flag for flag; --device is the port's
own).

Instance images come from one video (--instance_video: N evenly spaced
frames, or with --instance_video_mode consecutive its first N) or an
image directory (--instance_data_dir); their VAE posterior moments are
encoded once (fp32, one image a call) and a fresh latent is drawn from
them every step. --class_data_dir / --class_data_dir_2 give the content
and style prior-preservation images (--with_prior_preservation first
tops each up to --num_class_images with the base model). The trainer is
training/stage1.py: the three-group optimizer (AdamW, --optimizer
adamw8bit or prodigy), the merger similarity and, with
--with_period_column_separation, the cone-driven column masks. A
checkpoint (the LoRA leaves, the three optimizer groups, the masks,
scores and flags) is written every --checkpointing_steps under
<output_dir>/checkpoints, and --resume_from_checkpoint (a path, or
latest) continues from one. metrics.jsonl gets the losses and the
per-block LoRA norms and merger means every 10 steps; validation images
in the three modes every --validation_epochs steps; cone column scores
under grad_records/ at each selection with --with_grad_record. At the
end the reference's four artifacts are written under --output_dir
(``cli.infer --unziplora_name_or_path`` and the video CLI read them);
--final_inference_check reads them back, checks them against the
trained tensors bitwise and generates once. ``train(args, report,
images=..., class_images=...)`` runs it on image arrays held in memory.

--data_parallel N trains on N processes (torchrun --nproc_per_node N, or
the coordinator flags on each; the reference's ``accelerate launch``
DDP): each takes --train_batch_size rows of the global batch, the
gradients are summed over the processes before the column separation
reads them, so every process selects the same columns and makes the
same update. --scale_lr also multiplies by N. Process 0 makes the class
images (the others wait), and writes the checkpoints, metrics,
validation images, grad records and artifacts, to an output directory
every host shares.

    python -m video_style_transfer_tpu_torch.cli.train_unziplora \\
        --instance_video horse.mp4 --instance_prompt "a sbu horse in szn style" \\
        --content_forward_prompt "a sbu horse" \\
        --style_forward_prompt "an image in szn style" \\
        --with_period_column_separation --device cuda
"""
from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from video_style_transfer_tpu_torch.cli import common
from video_style_transfer_tpu_torch.cli.train_animatediff import run_seed
from video_style_transfer_tpu_torch.lora.surgery import (
    FREEZE_UNET_CONTENT, FREEZE_UNET_STYLE)
from video_style_transfer_tpu_torch.utils import tracing


def _bool(s):
    return str(s).lower() in ("1", "true", "yes", "y")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", default=None,
                   help="diffusers-layout SDXL directory (seeded random "
                        "full-width weights without one)")
    p.add_argument("--instance_video", default=None)
    p.add_argument("--instance_data_dir", default=None,
                   help="image directory alternative to --instance_video")
    p.add_argument("--num_instance_frames", type=int, default=1)
    p.add_argument("--instance_video_mode", default="spaced",
                   choices=["spaced", "consecutive"],
                   help="spaced: N evenly spaced frames; consecutive: the "
                        "first N")
    p.add_argument("--instance_prompt", required=True)
    p.add_argument("--content_forward_prompt", required=True)
    p.add_argument("--style_forward_prompt", required=True)
    p.add_argument("--compilation_cache_dir", default=None,
                   help="no effect here: XLA's compile cache")
    p.add_argument("--output_dir", default="out/unziplora")
    p.add_argument("--name", default="unziplora")
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=600)
    p.add_argument("--content_learning_rate", type=float, default=5e-5)
    p.add_argument("--style_learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_learning_rate", type=float, default=5e-3)
    p.add_argument("--similarity_lambda", type=float, default=0.5)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adamw8bit", "prodigy"],
                   help="adamw8bit keeps the moments blockwise in 8 bits "
                        "(training/adam8bit.py); prodigy adapts its step "
                        "size (training/prodigy.py)")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="reference spelling for --optimizer adamw8bit")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-4)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--prodigy_beta3", type=float, default=None,
                   help="None: sqrt(beta2)")
    p.add_argument("--prodigy_decouple", type=_bool, default=True,
                   help="accepted; prodigy here is always decoupled")
    p.add_argument("--prodigy_use_bias_correction", type=_bool,
                   default=True,
                   help="accepted; prodigy here is always bias-corrected")
    p.add_argument("--prodigy_safeguard_warmup", type=_bool, default=True)
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine", "cosine_with_restarts",
                            "polynomial"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lr_num_cycles", type=int, default=1,
                   help="hard restarts (cosine_with_restarts only)")
    p.add_argument("--lr_power", type=float, default=1.0,
                   help="polynomial decay power")
    p.add_argument("--scale_lr", action="store_true",
                   help="multiply the learning rates by accumulation "
                        "steps x batch size x data-parallel processes")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split the batch over N processes, each taking "
                        "--train_batch_size rows (the reference's "
                        "accelerate-launch DDP). 0 (default): every "
                        "process of the run")
    common.add_distributed_flags(p, "training run")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="a checkpoint directory, or latest (the newest "
                        "under <output_dir>/checkpoints; none there starts "
                        "afresh)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_period_column_separation", action="store_true")
    p.add_argument("--sample_times", type=int, default=3)
    p.add_argument("--column_ratio", type=float, default=0.1)
    p.add_argument("--with_no_overlap_first", action="store_true",
                   default=True)
    p.add_argument("--with_finetune_mask", action="store_true")
    p.add_argument("--with_freeze_unet", action="store_true",
                   help="the reference's block-separation tables "
                        "(lora/surgery.py FREEZE_UNET_*)")
    p.add_argument("--class_data_dir", default=None,
                   help="content prior-preservation image directory")
    p.add_argument("--class_prompt", default=None)
    p.add_argument("--prior_loss_weight", type=float, default=0.0)
    p.add_argument("--class_data_dir_2", default=None,
                   help="style prior-preservation image directory")
    p.add_argument("--class_prompt_2", default=None)
    p.add_argument("--prior_loss_weight_2", type=float, default=0.0)
    p.add_argument("--with_prior_preservation", action="store_true",
                   help="top each class directory up to --num_class_images "
                        "with the base model before training")
    p.add_argument("--num_class_images", type=int, default=100)
    p.add_argument("--sample_batch_size", type=int, default=4,
                   help="batch size of class-image generation")
    p.add_argument("--prior_generation_steps", type=int, default=25)
    p.add_argument("--validation_prompt", default=None)
    p.add_argument("--validation_prompt_content", default=None)
    p.add_argument("--validation_prompt_style", default=None)
    p.add_argument("--validation_content", default=None,
                   help="with --validation_style and no "
                        "--validation_prompt: the prompt is "
                        "'{content} {style}'")
    p.add_argument("--validation_style", default=None)
    p.add_argument("--validation_epochs", type=int, default=200,
                   help="validation images in the modes both, content and "
                        "style every N steps")
    p.add_argument("--validation_steps", type=int, default=8,
                   help="DPM-Solver++ steps of a validation image")
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["no", "bf16", "fp16"],
                   help="no: fp32 UNet (the reference recipe); bf16 "
                        "(default): bf16 UNet, fp32 LoRA; fp16 maps to bf16")
    p.add_argument("--report_to", default="jsonl",
                   choices=["jsonl", "tensorboard", "wandb"])
    p.add_argument("--logging_dir", default=None,
                   help="metrics subdirectory under --output_dir")
    # the reference's launch scripts pass these; each is dead there too or
    # concerns a hub, a tracker's identity or a loader this trainer lacks
    for flag, typ in (("snr_gamma", float), ("text_encoder_lr", float),
                      ("adam_weight_decay_text_encoder", float),
                      ("cache_dir", str), ("revision", str),
                      ("hub_model_id", str), ("hub_token", str),
                      ("dataset_config_name", str), ("caption_column", str),
                      ("feature_prompt", str), ("entity", str),
                      ("tags", str), ("wandb_dir", str)):
        p.add_argument(f"--{flag}", type=typ, default=None,
                       help="accepted; no effect")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="accepted; no effect (every activation is stored: "
                        "a 1024^2 step fits one 80 GB card)")
    p.add_argument("--push_to_hub", action="store_true",
                   help="accepted; never pushes")
    p.add_argument("--dataset_name", default=None,
                   help="raises, as the reference does; use "
                        "--instance_data_dir")
    p.add_argument("--image_column", default="image",
                   help="accepted; no effect")
    p.add_argument("--smoke", action="store_true",
                   help="tiny configs, synthetic images at 16^2, f32")
    p.add_argument("--smoke_steps", type=int, default=None)
    p.add_argument("--final_inference_check", action="store_true",
                   help="after the export, read the artifacts back, check "
                        "them against the trained tensors and generate "
                        "once")
    p.add_argument("--pretrained_vae_model_name_or_path", default=None)
    p.add_argument("--center_crop", action="store_true", default=False,
                   help="centre-crop instead of random-crop non-square "
                        "images")
    p.add_argument("--crops_coords_top_left_h", type=int, default=0)
    p.add_argument("--crops_coords_top_left_w", type=int, default=0,
                   help="SDXL crop micro-conditioning in time_ids")
    p.add_argument("--num_train_epochs", type=int, default=None,
                   help="in place of --max_train_steps: epochs x "
                        "ceil(images / batch) updates")
    p.add_argument("--repeats", type=int, default=1,
                   help="dataset repeat factor (the epoch accounting)")
    p.add_argument("--num_validation_images", type=int, default=1)
    p.add_argument("--with_image_per_validation", action="store_true",
                   default=True)
    p.add_argument("--with_saved_per_validation", action="store_true",
                   help="also export the artifacts at each validation")
    p.add_argument("--with_grad_record", action="store_true",
                   help="write each selection's cone column scores to "
                        "grad_records/step<N>.npz for cli.cone_diagnostics")
    p.add_argument("--train_text_encoder", action="store_true",
                   help="raises, as the reference does")
    for flag in ("with_accumulate_cone", "with_one_shot",
                 "enable_xformers_memory_efficient_attention"):
        p.add_argument(f"--{flag}", action="store_true",
                       help="accepted; no effect")
    p.add_argument("--allow_tf32", action="store_true",
                   help="accepted; no effect (fp32 runs in fp32, the "
                        "kernels on their tf32x3 routes)")
    p.add_argument("--dataloader_num_workers", type=int, default=0,
                   help="accepted; the images are encoded once")
    p.add_argument("--local_rank", type=int, default=-1,
                   help="accepted; no effect")
    p.add_argument("--prior_generation_precision", default=None,
                   choices=[None, "no", "fp32", "fp16", "bf16"],
                   help="class-image generation dtype; fp16 maps to bf16")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    return p


def check_args(args):
    """The JAX CLI's refusals, warnings and flag rewrites."""
    if args.train_text_encoder:
        raise NotImplementedError(
            "--train_text_encoder is not implemented (the reference raises "
            "NotImplementedError here as well)")
    if args.dataset_name is not None:
        raise NotImplementedError(
            "--dataset_name is not implemented (the reference raises "
            "NotImplementedError here as well); use --instance_data_dir")
    if args.use_8bit_adam:
        args.optimizer = "adamw8bit"
    if not args.prodigy_decouple or not args.prodigy_use_bias_correction:
        print("warning: prodigy is always decoupled and bias-corrected; "
              "--prodigy_decouple/--prodigy_use_bias_correction False are "
              "ignored", flush=True)
    if (args.validation_prompt is None and args.validation_content
            and args.validation_style):
        args.validation_prompt = (f"{args.validation_content} "
                                  f"{args.validation_style}")


def instance_images(args, res: int):
    """(N, res, res, 3) in [-1, 1]: seeded noise under --smoke, else the
    frames of --instance_video or the images of --instance_data_dir."""
    from video_style_transfer_tpu_torch.data import video

    if args.smoke:
        gen = torch.Generator().manual_seed(1)
        return (torch.rand((args.num_instance_frames, res, res, 3),
                           generator=gen) * 2.0 - 1.0).numpy()
    if args.instance_video:
        if args.instance_video_mode == "consecutive":
            return video.extract_first_frames(
                args.instance_video, args.num_instance_frames, res)
        return video.extract_frames(args.instance_video,
                                    args.num_instance_frames, resolution=res)
    if args.instance_data_dir:
        return video.load_image_dir(args.instance_data_dir, res,
                                    crop=_crop(args), seed=args.seed)
    raise SystemExit("need --instance_video or --instance_data_dir")


def _crop(args) -> str:
    return "center" if args.center_crop else "random"


def ensure_class_images(args, bundle, class_data_dir, class_prompt,
                        res) -> int:
    """Top a class directory up to --num_class_images by sampling the base
    model (no LoRA) in batches of --sample_batch_size, the noise of each
    batch from seed (images already there + made so far); files are
    ``{index}-{sha1 of the pixels}.jpg``. Returns the number made."""
    import hashlib

    from video_style_transfer_tpu_torch.data.video_io import save_image
    from video_style_transfer_tpu_torch.pipelines.image import (
        generate_images)
    from video_style_transfer_tpu_torch.pipelines.sampling import (
        tile_conditioning)

    os.makedirs(class_data_dir, exist_ok=True)
    cur = len(os.listdir(class_data_dir))
    num_new = args.num_class_images - cur
    if num_new <= 0:
        return 0
    bsz = max(args.sample_batch_size, 1)
    prompt = class_prompt or ""
    with torch.no_grad():
        uncond = tile_conditioning(common.negative_conditioning(
            bundle, "", height=res, width=res), bsz)
        cond = tile_conditioning(common.make_conditioning(
            bundle, prompt, prompt, prompt, height=res, width=res), bsz)
        prec = args.prior_generation_precision
        pdtype = (torch.float32 if args.smoke or prec in ("no", "fp32")
                  else torch.bfloat16)
        made = 0
        while made < num_new:
            imgs = generate_images(
                bundle.unet, bundle.unet_cfg, bundle.vae, bundle.vae_cfg,
                uncond, cond, height=res, width=res, batch=bsz,
                num_steps=args.prior_generation_steps, mode="base",
                dtype=pdtype, vae_scale_factor=bundle.vae_scale_factor,
                device=bundle.device,
                generator=common.seeded_generator(cur + made)).cpu().numpy()
            for img in imgs[:num_new - made]:
                digest = hashlib.sha1(img.tobytes()).hexdigest()
                save_image(img, os.path.join(class_data_dir,
                                             f"{cur + made}-{digest}.jpg"))
                made += 1
    return made


def prepare(args, images=None, class_images=None):
    """Everything the loop needs: the models (seeded, or loaded), the
    instance and prior image sets' posterior moments, the prompt
    encodings, the LoRA, the optimizer and the state (restored from
    --resume_from_checkpoint), the step function. `images`: instance
    images (N, H, W, 3) in [-1, 1] in place of the flags' source;
    `class_images`: {"content" | "style": such an array} in place of the
    class directories. Returns a SimpleNamespace."""
    from video_style_transfer_tpu_torch.lora.surgery import (
        insert_unziplora, layer_assignments)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
    from video_style_transfer_tpu_torch.training import stage1
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt

    from video_style_transfer_tpu_torch.parallel import distributed

    check_args(args)
    dp = args.data_parallel
    device, grid = common.setup_distributed(
        args, data=dp or None, what=f"--data_parallel {dp}")
    dp = grid.data
    dtype = (torch.float32 if args.smoke or args.mixed_precision == "no"
             else torch.bfloat16)
    with tracing.recording(), tracing.span("load") as load:
        bundle = common.load_models(
            args.pretrained_model_name_or_path, smoke=args.smoke, motion=False,
            dtype=dtype, seed=0, device=device, encoder=True,
            vae_path=args.pretrained_vae_model_name_or_path)
        res = 16 if args.smoke else args.resolution
        time_ids = torch.tensor([[res, res, args.crops_coords_top_left_h,
                                  args.crops_coords_top_left_w, res, res]],
                                dtype=torch.float32, device=device)
    setup_s = load.host_s

    with tracing.recording(), tracing.span("encode_latents") as enc:
        if images is None:
            images = instance_images(args, res)
        moments = common.encode_latent_moments(bundle, images)
        if args.with_prior_preservation and class_images is None:
            if not args.class_data_dir:
                raise SystemExit(
                    "--with_prior_preservation needs --class_data_dir")
            if args.class_prompt is None:
                raise SystemExit(
                    "--with_prior_preservation needs --class_prompt")
            # process 0 makes them, the others wait, then all read them
            if distributed.is_main_process():
                for ddir, prompt in ((args.class_data_dir, args.class_prompt),
                                     (args.class_data_dir_2,
                                      args.class_prompt_2)):
                    if ddir:
                        n = ensure_class_images(args, bundle, ddir, prompt,
                                                res)
                        if n:
                            print(f"generated {n} class images under {ddir}",
                                  flush=True)
            distributed.barrier("class_images")
        priors = {}
        for branch, ddir, prompt in (
                ("content", args.class_data_dir, args.class_prompt),
                ("style", args.class_data_dir_2, args.class_prompt_2)):
            if class_images is not None:
                imgs = class_images.get(branch)
            elif ddir:
                from video_style_transfer_tpu_torch.data.video import (
                    load_image_dir)
                imgs = load_image_dir(ddir, res, crop=_crop(args),
                                      seed=args.seed)
            else:
                imgs = None
            if imgs is None:
                continue
            if args.with_prior_preservation:
                imgs = imgs[:args.num_class_images]
            with torch.no_grad():
                emb, pooled = common.encode_prompt(bundle, prompt or "")
            priors[branch] = {"moments": common.encode_latent_moments(bundle,
                                                                       imgs),
                              "ctx": emb, "pooled": pooled}
    encode_s = enc.host_s

    with torch.no_grad():
        emb, pooled = common.encode_prompt(bundle, args.instance_prompt)
        emb_c, _ = common.encode_prompt(bundle, args.content_forward_prompt)
        emb_s, _ = common.encode_prompt(bundle, args.style_forward_prompt)

    params, lora_state = insert_unziplora(bundle.unet, Init(args.seed, device),
                                          rank=args.rank)
    freeze = args.with_freeze_unet
    assignments = layer_assignments(
        params, FREEZE_UNET_CONTENT if freeze else {},
        FREEZE_UNET_STYLE if freeze else {},
        layers_per_block=bundle.unet_cfg.layers_per_block)

    accum = max(args.gradient_accumulation_steps, 1)
    n_items = len(images) * max(args.repeats, 1)
    batches_per_epoch = max(-(-n_items // (args.train_batch_size * dp)), 1)
    updates_per_epoch = max(-(-batches_per_epoch // accum), 1)
    if args.num_train_epochs is not None:
        args.max_train_steps = args.num_train_epochs * updates_per_epoch
    max_steps = args.smoke_steps or args.max_train_steps
    if args.scale_lr:
        scale = accum * args.train_batch_size * dp
        args.content_learning_rate *= scale
        args.style_learning_rate *= scale
        args.weight_learning_rate *= scale

    sep = stage1.ColumnSepConfig(
        enabled=args.with_period_column_separation, max_steps=max_steps,
        sample_times=args.sample_times, steps_per_epoch=updates_per_epoch,
        column_ratio=args.column_ratio, avoid=args.with_no_overlap_first,
        finetune_mask=args.with_finetune_mask)
    if sep.enabled and updates_per_epoch >= sep.sampled_steps:
        # the reference state machine's arithmetic: pos = step %
        # sampled_steps never reaches the selection branch
        print(f"WARNING: column separation will never select — "
              f"updates/epoch ({updates_per_epoch}) >= sampled_steps "
              f"({sep.sampled_steps} = ceil(max_steps/sample_times)). "
              f"Raise --max_train_steps or lower --sample_times/"
              f"--repeats/dataset size (same arithmetic as the "
              f"reference state machine).", flush=True)

    opt = stage1.make_optimizer(
        params, lr_content=args.content_learning_rate,
        lr_style=args.style_learning_rate,
        lr_merger=args.weight_learning_rate,
        weight_decay=args.adam_weight_decay, b1=args.adam_beta1,
        b2=args.adam_beta2, eps=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, total_steps=max_steps,
        warmup=args.lr_warmup_steps, schedule=args.lr_scheduler,
        num_cycles=args.lr_num_cycles, power=args.lr_power,
        optimizer=args.optimizer, prodigy_beta3=args.prodigy_beta3,
        prodigy_safeguard_warmup=args.prodigy_safeguard_warmup)
    state = stage1.init_state(params, lora_state, opt)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    resumed_from = None
    if args.resume_from_checkpoint:
        resumed_from = (ckpt.latest_checkpoint(ckpt_dir)
                        if args.resume_from_checkpoint == "latest"
                        else args.resume_from_checkpoint)
        if resumed_from:
            extra = checkpoint_extra(state)
            state.step = ckpt.restore_checkpoint(resumed_from,
                                                 opt.trainable, opt, extra)
            state.orth_on, state.merger_on = map(bool, extra["flags"])
            if distributed.is_main_process():
                print(f"resumed from {resumed_from} at step {state.step}",
                  flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(run_seed(args.seed, state.step))
    step_fn = stage1.make_train_step(
        bundle.unet_cfg, make_schedule(), sep_cfg=sep,
        assignments=assignments, similarity_lambda=args.similarity_lambda,
        prior_weight=args.prior_loss_weight,
        prior_weight_2=args.prior_loss_weight_2, dtype=dtype, grid=grid)
    return SimpleNamespace(
        device=device, dtype=dtype, bundle=bundle, res=res, moments=moments,
        grid=grid,
        priors=priors, cond={"ctx": emb, "ctx_content": emb_c,
                             "ctx_style": emb_s, "pooled": pooled,
                             "time_ids": time_ids},
        assignments=assignments, sep=sep, optimizer=opt, state=state,
        start=state.step, max_steps=max_steps, accum=accum,
        ckpt_dir=ckpt_dir, resumed_from=resumed_from, generator=gen,
        host_rng=np.random.default_rng([args.seed, state.step]),
        step=step_fn, setup_s=setup_s, encode_s=encode_s)


def checkpoint_extra(state):
    """What a stage-1 checkpoint holds beside the LoRA leaves and the
    optimizer: the LoRA state tree and [orth_on, merger_on]."""
    return {"lora_state": state.lora_state,
            "flags": torch.tensor([state.orth_on, state.merger_on])}


def micro_batches(tr, batch_size: int):
    """One step's micro-batches: --gradient_accumulation_steps of
    `batch_size` rows each, the instance rows (and each prior branch's)
    drawn uniformly from their image set by the host generator, their
    latents from the device generator. Data-parallel, every process
    draws the global batch (batch_size x processes rows a micro-batch)
    and keeps its own rows of each micro-batch."""
    dp = tr.grid.data
    batch_size *= dp
    b = batch_size * tr.accum
    idx = tr.host_rng.integers(0, tr.moments[0].shape[0], size=b)
    with torch.no_grad():
        full = {"latents": common.sample_scaled_latents(
                    tr.bundle, tr.moments, torch.as_tensor(idx),
                    tr.generator),
                **{k: v.repeat((b,) + (1,) * (v.dim() - 1))
                   for k, v in tr.cond.items()}}
        for branch, prior in tr.priors.items():
            pidx = tr.host_rng.integers(0, prior["moments"][0].shape[0],
                                        size=b)
            full[f"prior_{branch}"] = {
                "latents": common.sample_scaled_latents(
                    tr.bundle, prior["moments"], torch.as_tensor(pidx),
                    tr.generator),
                "ctx": prior["ctx"].repeat(b, 1, 1),
                "pooled": prior["pooled"].repeat(b, 1),
                "time_ids": tr.cond["time_ids"].repeat(b, 1)}

    def chunk(tree, i):
        if isinstance(tree, dict):
            return {k: chunk(v, i) for k, v in tree.items()}
        return tree[i * batch_size:(i + 1) * batch_size]

    return [tr.grid.take(chunk(full, i)) for i in range(tr.accum)]


def grad_record(lora_state, assignments):
    """Each projection's cone column scores under the JAX package's keys:
    "<stacked path>.score_<branch>" -> (layers, out), the layer index
    taken out of the path and its layers stacked in order."""
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    stacks = {}
    for path in assignments:
        i = path.index("transformer_blocks")
        name = ".".join(str(x) for x in path[:i + 1] + path[i + 2:])
        stacks.setdefault(name, []).append(tree_get(lora_state, path))
    rec = {}
    for name, entries in stacks.items():
        for b in ("content", "style"):
            rec[f"{name}.score_{b}"] = torch.stack(
                [e[f"score_{b}"] for e in entries]).cpu().numpy()
    return rec


def run_validation(args, tr, step: int, logger=None):
    """Validation images in the modes both, content and style (each mode's
    prompt, DPM-Solver++ at --validation_steps, the noise of image i from
    seed i), saved under <output_dir>/validation and logged."""
    from video_style_transfer_tpu_torch.data.video_io import save_image
    from video_style_transfer_tpu_torch.pipelines.image import (
        generate_images)

    val_dir = os.path.join(args.output_dir, "validation")
    os.makedirs(val_dir, exist_ok=True)
    b, res = tr.bundle, tr.res
    prompts = {"both": args.validation_prompt,
               "content": args.validation_prompt_content
               or args.validation_prompt,
               "style": args.validation_prompt_style
               or args.validation_prompt}
    with torch.no_grad():
        uncond = common.negative_conditioning(b, "", height=res, width=res)
        for mode, prompt in prompts.items():
            cond = common.make_conditioning(b, prompt, prompt, prompt,
                                            height=res, width=res)
            for i in range(max(args.num_validation_images, 1)):
                img = generate_images(
                    tr.state.params, b.unet_cfg, b.vae, b.vae_cfg, uncond,
                    cond, height=res, width=res,
                    num_steps=args.validation_steps, mode=mode,
                    sampler="dpm", state=tr.state.lora_state,
                    dtype=tr.dtype, vae_scale_factor=b.vae_scale_factor,
                    device=tr.device,
                    generator=common.seeded_generator(i))[0].cpu().numpy()
                suffix = f"_{i}" if args.num_validation_images > 1 else ""
                save_image(img, os.path.join(
                    val_dir, f"step{step}_{mode}{suffix}.png"))
                if logger is not None:
                    logger.log_images(step, {f"validation/{mode}{suffix}":
                                             img})


def artifact_mismatches(params, lora_state, re_params):
    """The projections whose re-imported artifact tensors differ from the
    trained ones (down, up with its column gate folded in, mergers),
    bitwise."""
    from video_style_transfer_tpu_torch.lora.interop import (
        iter_layer_modules)
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    from video_style_transfer_tpu_torch.lora.unzip import export_weights

    bad = []
    for path, proj, name in iter_layer_modules(params):
        lp = tree_get(params, path)[proj].get("lora")
        if lp is None:
            continue
        rp = tree_get(re_params, path)[proj]["lora"]
        st = tree_get(lora_state, path)[proj]
        ok = all(torch.equal(rp[f"merge_{b}"].cpu(),
                             lp[f"merge_{b}"].detach().cpu())
                 for b in ("content", "style"))
        for b in ("content", "style"):
            down, up = export_weights(lp, st, b)
            ok = ok and torch.equal(rp[b]["down"].cpu(),
                                    down.detach().t().cpu())
            ok = ok and torch.equal(rp[b]["up"].cpu(), up.detach().t().cpu())
        if not ok:
            bad.append(name)
    return bad


def final_inference_check(args, tr, paths):
    """Read the exported artifacts into the base UNet, check them against
    the trained tensors bitwise, generate one image in mode both; returns
    its path."""
    from video_style_transfer_tpu_torch.data.video_io import save_image
    from video_style_transfer_tpu_torch.lora import interop
    from video_style_transfer_tpu_torch.pipelines.image import (
        generate_images)

    b, res = tr.bundle, tr.res
    re_params, re_state = interop.import_state_dicts(
        tr.state.params, interop.load_safetensors(paths["content"]),
        interop.load_safetensors(paths["style"]),
        interop.load_merger_pth(paths["merger_content"]),
        interop.load_merger_pth(paths["merger_style"]))
    bad = artifact_mismatches(tr.state.params, tr.state.lora_state,
                              re_params)
    if bad:
        raise RuntimeError(f"the exported artifacts differ from the trained "
                           f"tensors at {len(bad)} projections, e.g. "
                           f"{bad[:3]}")
    with torch.no_grad():
        cond = common.make_conditioning(
            b, args.validation_prompt or args.instance_prompt, height=res,
            width=res)
        uncond = common.negative_conditioning(b, "", height=res, width=res)
        img = generate_images(
            re_params, b.unet_cfg, b.vae, b.vae_cfg, uncond, cond,
            height=res, width=res, num_steps=args.validation_steps,
            mode="both", state=re_state, dtype=tr.dtype,
            vae_scale_factor=b.vae_scale_factor, device=tr.device,
            generator=common.seeded_generator(0))[0].cpu().numpy()
    out = save_image(img, os.path.join(args.output_dir,
                                       "final_check_both.png"))
    print("final reload+inference check OK:", out, flush=True)
    return out


def _selected(lora_state, assignments):
    """Columns in the masks, per branch, as device counts (read later)."""
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    return {b: sum(tree_get(lora_state, p)[f"mask_{b}"].sum()
                   for p in assignments)
            for b in ("content", "style")}


def train(args, report=None, on_setup=None, images=None, class_images=None,
          on_grads=None):
    """Run stage 1 from the start step (0, or the resumed checkpoint's) to
    the run's step count and export the artifacts; returns the trainer
    (prepare's namespace). `images`, `class_images`: see prepare.
    on_setup(trainer) runs once before the first step; on_grads(state,
    grads) sees each step's averaged, ungated gradients by trainable path
    (training.stage1.make_train_step). When `report` is a dict it
    receives setup_s (models and conditioning), encode_s (the image sets'
    VAE encode), start_step, max_steps, per step sample_s (drawing the
    latents), step_s, phase and the losses, selected_columns (per branch,
    after each step), checkpoints and checkpoint_s, validation_s, peak
    memory (peak_memory_gib on CUDA, from the first step on), artifacts,
    export_s and final_check (the image written, or None): host seconds
    of the spans of ``utils.tracing`` (a step's: ``train.step`` less its
    ``data``). Nothing waits for the device between log steps: the
    losses and column counts are read at each logged step, and a step's
    time shows where the host next waits. metrics.jsonl gets
    sec_per_step (wall seconds between logged steps over the steps),
    data_s and optimizer_s (host seconds a step in ``data`` and
    ``optimizer`` spans since the last log)."""
    from video_style_transfer_tpu_torch.parallel import distributed
    from video_style_transfer_tpu_torch.training import stage1
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt
    from video_style_transfer_tpu_torch.utils.observability import (
        MetricsLogger, lora_merge_log, lora_norm_log)

    if report is None:
        report = {}
    tr = prepare(args, images, class_images)
    report.update(setup_s=tr.setup_s, encode_s=tr.encode_s,
                  start_step=tr.start, max_steps=tr.max_steps, sample_s=[],
                  step_s=[], phase=[], losses=[], selected_columns=[],
                  checkpoints=[], checkpoint_s=[], validation_s=[],
                  trainable_tensors=len(tr.optimizer.trainable),
                  trainable_params=sum(t.numel() for _, t in
                                       tr.optimizer.trainable))
    if on_setup is not None:
        on_setup(tr)
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(tr.device)
    log_dir = (os.path.join(args.output_dir, args.logging_dir)
               if args.logging_dir else args.output_dir)
    logger = MetricsLogger(log_dir,
                           use_tensorboard=args.report_to == "tensorboard",
                           use_wandb=args.report_to == "wandb",
                           project=args.name)
    state, sep = tr.state, tr.sep
    is_main = distributed.is_main_process()
    pending = []        # (metrics, selected columns) on the device

    def read_pending():
        """The steps since the last read, their numbers on the host."""
        with tracing.span("sync.metrics"):
            for metrics, selected in pending:
                report["losses"].append({k: float(v)
                                         for k, v in metrics.items()})
                report["selected_columns"].append(
                    {b: int(n) for b, n in selected.items()})
        pending.clear()

    with tracing.recording() as rec:
        last_log = (tr.start, tracing.now())
        try:
            for step in range(tr.start, tr.max_steps):
                with tracing.span("train.step"):
                    with tracing.span("data"):
                        micro = micro_batches(tr, args.train_batch_size)
                    phase = (stage1.phase_name(step, sep) if sep.enabled
                             else None)
                    metrics = tr.step(state, micro, tr.generator,
                                      on_grads=on_grads)
                report["phase"].append(phase)
                pending.append((metrics, _selected(state.lora_state,
                                                   tr.assignments)))
                if step % 10 == 0 or step == tr.max_steps - 1:
                    read_pending()
                    spans = rec.take()
                    steps = common.step_seconds(spans, report, "sample_s")
                    scalars = dict(report["losses"][-1])
                    scalars.update(
                        sec_per_step=tracing.since(last_log[1])
                        / max(step - last_log[0], 1),
                        **common.log_seconds(spans, steps))
                    last_log = (step, tracing.now())
                    for branch in ("content", "style"):
                        scalars.update(lora_norm_log(state.params, branch))
                        scalars.update(lora_merge_log(state.params, branch))
                    logger.log(step, scalars)
                    if is_main:
                        print(f"step {step}: loss={scalars['loss']:.4f} "
                              f"({report['step_s'][-1]:.3f} s, phase "
                              f"{phase})", flush=True)
                if (step + 1) % args.checkpointing_steps == 0:
                    with tracing.span("checkpoint") as sp:
                        path = ckpt.save_checkpoint_main_process(
                            tr.ckpt_dir, lambda: ckpt.train_state(
                                tr.optimizer.trainable, tr.optimizer,
                                step + 1, extra=checkpoint_extra(state)),
                            step + 1, total_limit=args.checkpoints_total_limit)
                    report["checkpoints"].append(path)
                    report["checkpoint_s"].append(sp.host_s)
                    if is_main:
                        print(f"saved checkpoint: {path}", flush=True)
                if args.validation_prompt and is_main and \
                        (step + 1) % args.validation_epochs == 0:
                    with tracing.span("validation") as sp:
                        if args.with_image_per_validation:
                            run_validation(args, tr, step + 1, logger)
                        if args.with_saved_per_validation:
                            vdir = os.path.join(
                                args.output_dir,
                                f"validation_save_step{step + 1}")
                            os.makedirs(vdir, exist_ok=True)
                            ckpt.export_stage1_artifacts(
                                vdir, args.name, state.params,
                                state.lora_state)
                    report["validation_s"].append(sp.host_s)
                ne, ss = sep.steps_per_epoch, sep.sampled_steps
                if (args.with_grad_record and sep.enabled and is_main
                        and step >= ne
                        and (step - ne) % ss == 0
                        and step < sep.sample_times * ss):
                    rec_dir = os.path.join(args.output_dir, "grad_records")
                    os.makedirs(rec_dir, exist_ok=True)
                    np.savez(os.path.join(rec_dir, f"step{step + 1}.npz"),
                             **grad_record(state.lora_state, tr.assignments))
        finally:
            logger.close()
        read_pending()
        common.step_seconds(rec.take(), report, "sample_s")
        if tr.device.type == "cuda":
            report["peak_memory_gib"] = (
                torch.cuda.max_memory_allocated(tr.device) / 2 ** 30)
        report["artifacts"] = report["final_check"] = None
        if not is_main:
            return tr
        with tracing.span("export") as sp:
            paths = ckpt.export_stage1_artifacts(
                args.output_dir, args.name, state.params, state.lora_state)
    report["artifacts"] = paths
    report["export_s"] = sp.host_s
    print("saved artifacts:", paths, flush=True)
    report["final_check"] = (final_inference_check(args, tr, paths)
                             if args.final_inference_check else None)
    return tr


def main(argv=None):
    args = build_parser().parse_args(argv)
    report = {}
    train(args, report)
    return report["artifacts"]


if __name__ == "__main__":
    main()
