"""Stage-2 CLI: temporal-LoRA motion fine-tuning (the JAX package's
cli/train_animatediff.py). Defaults mirror the reference's
train_animatediff.sh: 8 frames at 1024^2, batch 1, AdamW 2e-5 with cosine
decay after 100 warmup steps, clip 0.5, temporal-LoRA rank 32, bf16 UNet,
fp32 VAE encode.

Checkpoints, stage-1 artifacts and videos cannot be loaded yet, so it
trains on what the JAX CLI uses when none is given: seeded random
full-width SDXL + AnimateDiff-XL weights, rank-4 UnZipLoRA stage-1 LoRAs,
and synthetic clips in [-1, 1]. Flags for files or features of later
slices raise. ``train(args, report)`` runs the loop and returns the
trained params; ``main()`` also writes the trainable tensors with
torch.save.

    python -m video_style_transfer_tpu_torch.cli.train_animatediff \\
        --prompt "a horse galloping" --device cuda
"""
from __future__ import annotations

import argparse
import os

import torch

from video_style_transfer_tpu_torch.cli import common
from video_style_transfer_tpu_torch.cli.infer_video import _Clock

# flag -> what it waits for
NOT_PORTED = {
    "pretrained_model_name_or_path": "checkpoint loading (loader slice)",
    "unziplora_name_or_path": "stage-1 artifact import (lora/interop.py)",
    "unziplora_content_path": "stage-1 artifact import (lora/interop.py)",
    "unziplora_style_path": "stage-1 artifact import (lora/interop.py)",
    "unziplora_content_weight_path": "stage-1 artifact import",
    "unziplora_style_weight_path": "stage-1 artifact import",
    "video_dir": "the video dataset and latent-moment cache",
    "instance_data_dir": "the video dataset and latent-moment cache",
    "motion_adapter_path": "motion checkpoint import "
                           "(utils/motion_convert.py)",
    "resume_from_checkpoint": "checkpoint save/restore (utils/checkpoint.py)",
    "checkpointing_steps": "checkpoint save/restore (utils/checkpoint.py)",
    "num_train_epochs": "the video dataset (epoch accounting)",
    "data_parallel": "multi-GPU training (slice E)",
    "frame_parallel": "multi-GPU training (slice E)",
    "num_processes": "multi-GPU training (slice E)",
}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    for flag in NOT_PORTED:
        p.add_argument(f"--{flag}", default=None,
                       help=f"not ported yet: waits for {NOT_PORTED[flag]}")
    p.add_argument("--prompt", default=None)
    p.add_argument("--instance_prompt", default=None,
                   help="reference spelling for --prompt")
    p.add_argument("--output_dir", default="out/animatediff")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=1000)
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
                   help="adamw8bit is not ported yet")
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
    p.add_argument("--prediction_type", default="epsilon",
                   choices=["epsilon", "v_prediction"])
    p.add_argument("--unfreeze_mergers", action="store_true")
    p.add_argument("--train_full_motion", action="store_true",
                   help="fine-tune every motion-module weight, attention "
                        "bases included")
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["no", "bf16", "fp16"],
                   help="UNet dtype; fp16 maps to bf16, as in the JAX CLI")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    p.add_argument("--smoke", action="store_true",
                   help="tiny configs: 4 frames at 16^2, f32")
    return p


def _refuse_unported(args):
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} is not ported yet (it waits for "
                             f"{why})")
    if args.optimizer != "adamw":
        raise SystemExit(f"--optimizer {args.optimizer} is not ported yet "
                         f"(it waits for training/adam8bit.py)")


def prepare(args):
    """Build everything the loop needs: models (seeded), the stage-1 and
    temporal LoRAs, the trainable split, the optimizer, the prompt
    encodings and the step function. Returns a SimpleNamespace."""
    from types import SimpleNamespace

    from video_style_transfer_tpu_torch.lora.surgery import (
        insert_temporal_lora, insert_unziplora, spatial_pairs)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
    from video_style_transfer_tpu_torch.training import stage2

    _refuse_unported(args)
    prompt = args.prompt or args.instance_prompt
    if not prompt:
        raise SystemExit("need --prompt (or --instance_prompt)")
    device = common.resolve_device(args.device)
    smoke = args.smoke
    res = 16 if smoke else args.resolution
    dtype = (torch.float32 if smoke or args.mixed_precision == "no"
             else torch.bfloat16)
    b = args.train_batch_size

    bundle = common.load_models(None, smoke=smoke, motion=True, dtype=dtype,
                                seed=0, device=device, encoder=True)
    params, lora_state = insert_unziplora(
        bundle.unet, Init(args.seed, device), rank=4)
    insert_temporal_lora(params, Init(args.seed + 1, device),
                         rank=args.temporal_lora_rank,
                         alpha=args.temporal_lora_alpha)
    mask = stage2.trainable_mask(params, train_mergers=args.unfreeze_mergers,
                                 train_full_motion=args.train_full_motion)
    trainable = stage2.split_trainable(params, mask)
    opt = stage2.make_optimizer(
        [t for _, t in trainable], lr=args.learning_rate,
        total_steps=args.max_train_steps, warmup=args.lr_warmup_steps,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
        schedule=args.lr_scheduler, num_cycles=args.lr_num_cycles,
        power=args.lr_power)
    with torch.no_grad():
        emb, pooled = common.encode_prompt(bundle, prompt)
        # the empty-prompt encodings for the CFG-dropout swap
        uemb, upooled = common.encode_prompt(bundle, "")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return SimpleNamespace(
        device=device, bundle=bundle, params=params, trainable=trainable,
        optimizer=opt, generator=gen, res=res,
        frames=4 if smoke else args.num_frames, batch=b,
        accum=max(args.gradient_accumulation_steps, 1),
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
            lora_state=lora_state, dtype=dtype))


def sample_micro_batches(tr):
    """One synthetic clip per micro-batch, fp32-encoded frame by frame."""
    micro = []
    with torch.no_grad():
        for _ in range(tr.accum):
            frames = torch.rand((tr.batch * tr.frames, tr.res, tr.res, 3),
                                generator=tr.generator,
                                device=tr.device) * 2.0 - 1.0
            lat = common.encode_latents(tr.bundle, frames,
                                        generator=tr.generator)
            micro.append({"latents": lat.reshape(tr.batch, tr.frames,
                                                 *lat.shape[1:]),
                          **tr.cond})
    return micro


def train(args, report=None, on_setup=None):
    """Run the stage-2 loop. Returns (params, trainable [(path, tensor)]).
    When `report` is a dict it receives weight_init_s (set-up through the
    prompt encodings) and per step encode_s, step_s and the losses (host
    seconds, each phase ending in a device synchronise), plus
    peak_memory_gib (from the first step on) on CUDA. on_setup(params,
    trainable) runs once before the first step."""
    if report is None:
        report = {}
    clock = _Clock(common.resolve_device(args.device))
    tr = prepare(args)
    report["weight_init_s"] = clock.lap()
    report.update(encode_s=[], step_s=[], loss=[], loss_mse=[],
                  loss_orth=[], trainable_tensors=len(tr.trainable),
                  trainable_params=sum(t.numel() for _, t in tr.trainable))
    if on_setup is not None:
        on_setup(tr.params, tr.trainable)
    if tr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(tr.device)
    clock.lap()
    for step in range(args.max_train_steps):
        micro = sample_micro_batches(tr)
        report["encode_s"].append(clock.lap())
        metrics = tr.step(tr.params, micro, tr.generator)
        report["step_s"].append(clock.lap())
        for k in ("loss", "loss_mse", "loss_orth"):
            report[k].append(float(metrics[k]))
        if step % args.log_every == 0 or step == args.max_train_steps - 1:
            print(f"step {step}: loss={report['loss'][-1]:.4f} "
                  f"mse={report['loss_mse'][-1]:.4f} "
                  f"orth={report['loss_orth'][-1]:.6f} "
                  f"({report['step_s'][-1]:.3f} s)", flush=True)
    if tr.device.type == "cuda":
        report["peak_memory_gib"] = (
            torch.cuda.max_memory_allocated(tr.device) / 2 ** 30)
    return tr.params, tr.trainable


def main(argv=None):
    from video_style_transfer_tpu_torch.lora.surgery import path_str

    args = build_parser().parse_args(argv)
    _, trainable = train(args)
    os.makedirs(args.output_dir, exist_ok=True)
    path = os.path.join(args.output_dir, "stage2_trainable.pt")
    torch.save({path_str(p): t.detach().cpu() for p, t in trainable}, path)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
