"""Stage-2 CLI: temporal-LoRA motion fine-tuning (the JAX package's
cli/train_animatediff.py). Defaults mirror the reference's
train_animatediff.sh: 8 frames at 1024^2, batch 1, AdamW 2e-5 with cosine
decay after 100 warmup steps, clip 0.5, temporal-LoRA rank 32, bf16 UNet,
fp32 VAE encode.

It loads a diffusers-layout SDXL directory, a stage-1 artifact set and
initial motion weights where their flags are given; without them it
trains on what the JAX CLI uses when none is given: seeded random
full-width SDXL + AnimateDiff-XL weights and rank-4 UnZipLoRA stage-1
LoRAs. Clips come from the videos under --video_dir (data/video.py), each
frame's posterior moments cached across steps (cli/common.py
LatentMomentCache; --no_latent_cache encodes every clip each step), or,
without a video directory, synthetic clips in [-1, 1]; under --smoke a
video directory without readable videos also falls back to them.
--num_train_epochs counts passes over the clip starts. A checkpoint of
the trainable tensors and the optimizer (AdamW, or --optimizer adamw8bit)
is written every --checkpointing_steps under <output_dir>/checkpoints,
and --resume_from_checkpoint (a path, or latest) continues from one. The
losses and seconds a step go to <output_dir>/metrics.jsonl (and
tensorboard or wandb with --report_to).

--data_parallel N and --frame_parallel M train on N x M processes
(torchrun --nproc_per_node, or the coordinator flags on each; the
reference's ``accelerate launch`` DDP): each process takes
--train_batch_size clips of the global batch and, with M > 1, its run
of their frames; the motion modules exchange frames; the gradients are
summed over the processes before the clip, so every process makes the
update one process would make from the global batch. Process 0 writes
the checkpoints, the metrics and the motion checkpoint, to an output
directory every host shares; every process resumes from it.
``train(args, report)`` runs the loop, writes the motion checkpoint
(every motion-module weight with the temporal LoRA folded in,
``motion_modules.safetensors`` or ``.pth`` under --output_dir, which
``cli.infer_video --motion_checkpoint`` reads) and returns the trainer.

    python -m video_style_transfer_tpu_torch.cli.train_animatediff \\
        --prompt "a horse galloping" --video_dir clips/ --device cuda
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from video_style_transfer_tpu_torch.cli import common
from video_style_transfer_tpu_torch.cli.infer_video import _Clock


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split the clips over N processes, each taking "
                        "--train_batch_size clips (the reference's "
                        "accelerate-launch DDP). 0 (default): every "
                        "process --frame_parallel leaves")
    p.add_argument("--frame_parallel", type=int, default=1,
                   help="split each clip's frames over N processes; the "
                        "motion modules exchange frames (one all-to-all "
                        "pair a module). N must divide the frame count")
    common.add_distributed_flags(p, "training run")
    p.add_argument("--pretrained_model_name_or_path", default=None,
                   help="diffusers-layout SDXL directory")
    p.add_argument("--video_dir", default=None,
                   help="directory of .mp4 training videos (and one level "
                        "of subdirectories)")
    p.add_argument("--instance_data_dir", default=None,
                   help="reference spelling for --video_dir")
    p.add_argument("--unziplora_name_or_path", default=None,
                   help="stage-1 artifact directory")
    p.add_argument("--unziplora_name", default="unziplora")
    # explicit per-artifact paths, the reference's spelling
    p.add_argument("--unziplora_content_path", default=None)
    p.add_argument("--unziplora_style_path", default=None)
    p.add_argument("--unziplora_content_weight_path", default=None)
    p.add_argument("--unziplora_style_weight_path", default=None)
    p.add_argument("--motion_adapter_path", default=None,
                   help="initial motion weights: diffusers MotionAdapter "
                        "safetensors, a trained motion_modules.pth, or a "
                        "directory holding either")
    p.add_argument("--checkpoint_format", default="safetensors",
                   choices=["safetensors", "pth"],
                   help="final motion checkpoint format; pth is the "
                        "reference's torch format")
    p.add_argument("--config_preset", default="sdxl",
                   choices=["sdxl", "tiny"],
                   help="topology of the --pretrained_model_name_or_path "
                        "directory: sdxl (default), or tiny, the synthetic "
                        "checkpoint of cli/verify_parity.py")
    p.add_argument("--prompt", default=None)
    p.add_argument("--instance_prompt", default=None,
                   help="reference spelling for --prompt")
    p.add_argument("--output_dir", default="out/animatediff")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=1000)
    p.add_argument("--num_train_epochs", type=int, default=None,
                   help="passes over the clip starts, in place of "
                        "--max_train_steps")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--lr_scheduler", default="cosine",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine", "cosine_with_restarts", "polynomial"])
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adamw8bit"],
                   help="adamw8bit keeps the Adam moments blockwise in 8 "
                        "bits (training/adam8bit.py)")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--weight_decay", "--adam_weight_decay",
                   dest="weight_decay", type=float, default=1e-2)
    p.add_argument("--max_grad_norm", type=float, default=0.5)
    p.add_argument("--temporal_lora_rank", type=int, default=32)
    p.add_argument("--temporal_lora_alpha", type=float, default=1.0)
    p.add_argument("--lambda_orth", type=float, default=1e-4)
    p.add_argument("--cfg_dropout", type=float, default=0.1)
    p.add_argument("--no_latent_cache", action="store_true",
                   help="encode every clip each step (the reference's "
                        "behaviour) instead of caching each frame's VAE "
                        "posterior moments")
    p.add_argument("--prediction_type", default="epsilon",
                   choices=["epsilon", "v_prediction"])
    p.add_argument("--unfreeze_mergers", action="store_true")
    p.add_argument("--train_full_motion", action="store_true",
                   help="fine-tune every motion-module weight, attention "
                        "bases included")
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["no", "bf16", "fp16"],
                   help="UNet dtype; fp16 maps to bf16, as in the JAX CLI")
    p.add_argument("--checkpointing_steps", type=int, default=500,
                   help="write <output_dir>/checkpoints/checkpoint-<step> "
                        "every N steps")
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="a checkpoint directory, or latest (the newest "
                        "under <output_dir>/checkpoints; none there "
                        "starts afresh)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--name", default="animatediff-stage2",
                   help="tracker run / project name")
    p.add_argument("--report_to", default="jsonl",
                   choices=["jsonl", "tensorboard", "wandb"],
                   help="metrics.jsonl under --output_dir always; "
                        "tensorboard or wandb (offline) besides, where "
                        "they import")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    p.add_argument("--smoke", action="store_true",
                   help="tiny configs: 4 frames at 16^2, f32")
    return p


def train_steps(args, n_items: int, dp: int = 1) -> int:
    """The run's step count: --num_train_epochs passes over `n_items`
    clip starts in global batches of --train_batch_size x `dp`, a step
    taking --gradient_accumulation_steps batches (the JAX CLI's
    accounting), else --max_train_steps."""
    if args.num_train_epochs is None:
        return args.max_train_steps
    accum = max(args.gradient_accumulation_steps, 1)
    batches = max(-(-n_items // (args.train_batch_size * dp)), 1)
    return args.num_train_epochs * max(-(-batches // accum), 1)


def run_seed(seed: int, start: int) -> int:
    """The trainer generator's seed: `seed` for a run from step 0; a run
    resumed at `start` folds it in, so that it does not replay the draws
    of the steps before its checkpoint."""
    if start == 0:
        return seed
    return int(np.random.SeedSequence([seed, start]).generate_state(
        1, np.uint64)[0])


def open_dataset(args, frames: int, res: int):
    """The VideoClipDataset of --video_dir (or --instance_data_dir), or
    None without one. Under --smoke a directory without readable videos
    gives None (synthetic clips), as in the JAX CLI; a missing cv2 raises
    always."""
    root = args.video_dir or args.instance_data_dir
    if not root:
        return None
    from video_style_transfer_tpu_torch.data.video import VideoClipDataset
    from video_style_transfer_tpu_torch.parallel import distributed
    try:
        ds = VideoClipDataset(root, num_frames=frames, resolution=res)
    except OSError:
        if not args.smoke:
            raise
        print(f"smoke: no readable videos under {root}; using synthetic "
              f"clips", flush=True)
        return None
    if distributed.is_main_process():
        print(f"clips: {len(ds)} starts of {frames} frames in "
              f"{len(ds.videos)} videos under {root}, preprocessing "
              f"{ds.preprocess}", flush=True)
    return ds


def prepare(args, dataset=None):
    """Build everything the loop needs: models (seeded), the stage-1 and
    temporal LoRAs, the trainable split, the clip source (`dataset`, an
    object with VideoClipDataset's ``__len__`` and ``sample_batch_meta``,
    or --video_dir's videos, or synthetic clips) and the moment cache, the
    optimizer (restored from --resume_from_checkpoint), the prompt
    encodings and the step function. Returns a SimpleNamespace."""
    from types import SimpleNamespace

    from video_style_transfer_tpu_torch.lora.surgery import (
        copy_structure, insert_temporal_lora, insert_unziplora,
        spatial_pairs)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
    from video_style_transfer_tpu_torch.training import stage2
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt

    prompt = args.prompt or args.instance_prompt
    if not prompt:
        raise SystemExit("need --prompt (or --instance_prompt)")
    smoke = args.smoke
    res = 16 if smoke else args.resolution
    frames = 4 if smoke else args.num_frames
    fp = max(args.frame_parallel, 1)
    if frames % fp:
        raise SystemExit(f"--frame_parallel {fp} must divide the frame "
                         f"count {frames}")
    device, grid = common.setup_distributed(
        args, data=args.data_parallel or None, frame=fp,
        what=f"--data_parallel {args.data_parallel} x --frame_parallel "
             f"{fp}")
    dtype = (torch.float32 if smoke or args.mixed_precision == "no"
             else torch.bfloat16)
    b = args.train_batch_size

    bundle = common.load_models(
        args.pretrained_model_name_or_path, smoke=smoke, motion=True,
        dtype=dtype, seed=0, device=device, encoder=True,
        configs=(common.tiny_checkpoint_configs(motion=True)
                 if args.config_preset == "tiny" else None))
    params = bundle.unet
    if args.motion_adapter_path:
        from video_style_transfer_tpu_torch.utils.motion_convert import (
            import_motion_state_dict, load_motion_checkpoint)
        params = import_motion_state_dict(
            params, load_motion_checkpoint(args.motion_adapter_path))
    if args.unziplora_name_or_path or (args.unziplora_content_path
                                       and args.unziplora_style_path):
        params, lora_state = common.load_unziplora(
            params, base=args.unziplora_name_or_path,
            name=args.unziplora_name,
            content_path=args.unziplora_content_path,
            style_path=args.unziplora_style_path,
            content_weight_path=args.unziplora_content_weight_path,
            style_weight_path=args.unziplora_style_weight_path)
    else:
        params, lora_state = insert_unziplora(
            params, Init(args.seed, device), rank=4)
    # the imports share the loaded tree's structure: the temporal LoRA
    # goes into a structure of its own
    params = copy_structure(params)
    insert_temporal_lora(params, Init(args.seed + 1, device),
                         rank=args.temporal_lora_rank,
                         alpha=args.temporal_lora_alpha)
    mask = stage2.trainable_mask(params, train_mergers=args.unfreeze_mergers,
                                 train_full_motion=args.train_full_motion)
    trainable = stage2.split_trainable(params, mask)

    if dataset is None:
        dataset = open_dataset(args, frames, res)
    cache = (None if args.no_latent_cache or dataset is None
             else common.LatentMomentCache(bundle))
    accum = max(args.gradient_accumulation_steps, 1)
    # the schedule's length depends on the step count
    max_steps = train_steps(args, len(dataset) if dataset is not None
                            else 1, grid.data)
    opt = stage2.make_optimizer(
        [t for _, t in trainable], lr=args.learning_rate,
        total_steps=max_steps, warmup=args.lr_warmup_steps,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
        schedule=args.lr_scheduler, num_cycles=args.lr_num_cycles,
        power=args.lr_power, optimizer=args.optimizer)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    start, resumed_from = 0, None
    if args.resume_from_checkpoint:
        resumed_from = (ckpt.latest_checkpoint(ckpt_dir)
                        if args.resume_from_checkpoint == "latest"
                        else args.resume_from_checkpoint)
        if resumed_from:
            start = ckpt.restore_checkpoint(resumed_from, trainable, opt)
            print(f"resumed from {resumed_from} at step {start}",
                  flush=True)
    with torch.no_grad():
        emb, pooled = common.encode_prompt(bundle, prompt)
        # the empty-prompt encodings for the CFG-dropout swap
        uemb, upooled = common.encode_prompt(bundle, "")
    gen = torch.Generator(device=device)
    gen.manual_seed(run_seed(args.seed, start))
    return SimpleNamespace(
        device=device, bundle=bundle, params=params, trainable=trainable,
        lora_state=lora_state, optimizer=opt, generator=gen, res=res,
        frames=frames, batch=b, accum=accum, seed=args.seed, grid=grid,
        dataset=dataset, cache=cache, max_steps=max_steps, start=start,
        ckpt_dir=ckpt_dir, resumed_from=resumed_from,
        cond={"ctx": emb.repeat(b, 1, 1), "pooled": pooled.repeat(b, 1),
              "uncond_ctx": uemb.repeat(b, 1, 1),
              "uncond_pooled": upooled.repeat(b, 1),
              "time_ids": torch.tensor([[res, res, 0, 0, res, res]],
                                       dtype=torch.float32,
                                       device=device).repeat(b, 1)},
        step=stage2.make_train_step(
            bundle.unet_cfg, make_schedule(), opt, spatial_pairs(params),
            lambda_orth=args.lambda_orth, cfg_dropout=args.cfg_dropout,
            prediction_type=args.prediction_type, mode="both",
            lora_state=lora_state, dtype=dtype, grid=grid))


def sample_micro_batches(tr, step: int = 0):
    """One global batch of clips per micro-batch as scaled latents,
    fp32-encoded frame by frame. From the dataset, micro-batch mi of
    `step` is ``sample_batch_meta(global batch, seed * 1000 + step *
    accum + mi)`` (the JAX CLI's draw), its latents drawn through the
    moment cache where there is one; without a dataset, a synthetic clip
    drawn from the trainer's generator. Every process draws the whole
    batch and encodes only its own clips and frames."""
    micro = []
    n_clips = tr.batch * tr.grid.data
    rows = tr.grid.positions(n_clips, tr.frames)
    with torch.no_grad():
        for mi in range(tr.accum):
            if tr.dataset is None:
                clip = torch.rand((n_clips * tr.frames, tr.res, tr.res, 3),
                                  generator=tr.generator,
                                  device=tr.device) * 2.0 - 1.0
                lat = common.encode_latents(tr.bundle, clip,
                                            generator=tr.generator,
                                            rows=rows)
            else:
                clips, ids = tr.dataset.sample_batch_meta(
                    n_clips, tr.seed * 1000 + step * tr.accum + mi)
                if tr.cache is not None:
                    lat = tr.cache.latents(clips, ids, tr.generator,
                                           rows=rows)
                else:
                    clip = torch.as_tensor(clips).reshape(
                        -1, *clips.shape[2:]).to(tr.device, torch.float32)
                    lat = common.encode_latents(tr.bundle, clip,
                                                generator=tr.generator,
                                                rows=rows)
            micro.append({"latents": lat.reshape(tr.batch, -1,
                                                 *lat.shape[1:]),
                          **tr.cond})
    return micro


def train(args, report=None, on_setup=None, dataset=None, on_grads=None):
    """Run the stage-2 loop from the start step (0, or the resumed
    checkpoint's) to the run's step count; returns the trainer
    (prepare's namespace: params, trainable, optimizer, generator, ...).
    `dataset`: a clip source with VideoClipDataset's interface, in place
    of --video_dir. When `report` is a dict it receives weight_init_s
    (set-up through the prompt encodings and any restore), start_step,
    max_steps, and per step encode_s, encoded_frames (frames that went
    through the VAE encoder), step_s and the losses (host seconds, each
    phase ending in a device synchronise), plus peak_memory_gib (from the
    first step on) on CUDA, checkpoints (the paths written) and
    motion_checkpoint, the file written at the end; the logged steps go
    to <output_dir>/metrics.jsonl. on_setup(trainer)
    runs once before the first step; on_grads(grads) sees each step's
    gradients (summed over the processes) before the update
    (training.stage2.make_train_step)."""
    from video_style_transfer_tpu_torch.parallel import distributed
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt
    from video_style_transfer_tpu_torch.utils.observability import (
        MetricsLogger, StepTimer)

    if report is None:
        report = {}
    clock = _Clock(common.resolve_device(args.device))
    tr = prepare(args, dataset)
    report["weight_init_s"] = clock.lap()
    report.update(encode_s=[], encoded_frames=[], step_s=[], loss=[],
                  loss_mse=[], loss_orth=[], checkpoints=[],
                  checkpoint_s=[], start_step=tr.start,
                  max_steps=tr.max_steps,
                  trainable_tensors=len(tr.trainable),
                  trainable_params=sum(t.numel() for _, t in tr.trainable))
    if on_setup is not None:
        on_setup(tr)
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(tr.device)
    logger = MetricsLogger(args.output_dir,
                           use_tensorboard=args.report_to == "tensorboard",
                           use_wandb=args.report_to == "wandb",
                           project=args.name)
    timer, last_log = StepTimer(), tr.start
    clock.lap()
    try:
        for step in range(tr.start, tr.max_steps):
            misses = tr.cache.misses if tr.cache is not None else 0
            micro = sample_micro_batches(tr, step)
            report["encode_s"].append(clock.lap())
            report["encoded_frames"].append(
                tr.cache.misses - misses if tr.cache is not None
                else tr.accum * tr.batch * tr.frames)
            metrics = tr.step(tr.params, micro, tr.generator,
                              on_grads=on_grads)
            report["step_s"].append(clock.lap())
            for k in ("loss", "loss_mse", "loss_orth"):
                report[k].append(float(metrics[k]))
            if step % args.log_every == 0 or step == tr.max_steps - 1:
                scalars = {k: report[k][-1]
                           for k in ("loss", "loss_mse", "loss_orth")}
                scalars["sec_per_step"] = timer.lap() / max(
                    step - last_log, 1)
                last_log = step
                logger.log(step, scalars)
                if distributed.is_main_process():
                    print(f"step {step}: loss={scalars['loss']:.4f} "
                          f"mse={scalars['loss_mse']:.4f} "
                          f"orth={scalars['loss_orth']:.6f} "
                          f"({report['step_s'][-1]:.3f} s)", flush=True)
            if (step + 1) % args.checkpointing_steps == 0:
                path = ckpt.save_checkpoint_main_process(
                    tr.ckpt_dir,
                    lambda: ckpt.train_state(tr.trainable, tr.optimizer,
                                             step + 1),
                    step + 1)
                report["checkpoints"].append(path)
                report["checkpoint_s"].append(clock.lap())
                if distributed.is_main_process():
                    print(f"saved checkpoint: {path}", flush=True)
    finally:
        logger.close()
    if tr.device.type == "cuda":
        report["peak_memory_gib"] = (
            torch.cuda.max_memory_allocated(tr.device) / 2 ** 30)
    out = os.path.join(args.output_dir,
                       f"motion_modules.{args.checkpoint_format}")
    if distributed.is_main_process():
        ckpt.export_motion_checkpoint(out, tr.params)
    distributed.barrier("motion-checkpoint")
    report["motion_checkpoint"] = out
    report["export_s"] = clock.lap()
    if distributed.is_main_process():
        print("saved motion checkpoint:", out, flush=True)
    return tr


def main(argv=None):
    args = build_parser().parse_args(argv)
    report = {}
    train(args, report)
    return report["motion_checkpoint"]


if __name__ == "__main__":
    main()
