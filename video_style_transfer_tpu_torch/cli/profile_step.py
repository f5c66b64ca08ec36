"""Where the time of one denoise or training step goes, on the GPU.

Builds the full-width SDXL + AnimateDiff-XL UNet with seeded random
weights (as ``cli.infer_video`` and ``cli.train_animatediff`` do without a
checkpoint) and warms each phase up once. Serving has one phase, a CFG
denoise call on a video's frames (bf16, or fp32 with ``--mixed_precision
no`` as ``cli.infer_video`` builds it), or with ``--image`` on one image
(plain SDXL, no motion modules); training (``--train``) has two, the
fp32 VAE encode of one clip and the train step (forward, backward,
optimizer update); ``--decode`` has one, the VAE decode of one frame
(serving decodes a video frame by frame) in fp32, or with ``--vae_dtype
bfloat16`` in bf16 as ``--vae_dtype`` of the CLIs decodes. Each
phase runs once without the profiler, then once traced with
``torch.profiler``, and is printed as one JSON line: its host seconds
both ways (each ending in a synchronise; their difference is the
profiler's own cost), the device kernels' summed time by category (the
port's kernels, GEMMs, convolutions, everything else) with launch counts,
the device's idle share between the first and the last kernel, peak
memory and the slowest kernel names.

With ``--steps N`` nothing is traced: each phase runs N more times and
its line holds every run's host seconds with the card's name and power
limit. The package is the one Python finds first, so the same file times
another checkout in the same call (``cd`` there, ``PYTHONPATH=.``, and
run this file by its path).

``--k1`` times K1's wrapper (``ops.flash_attention.flash_attention_fwd``)
alone at the shapes the paths give it (the UNet's bf16 self-attentions,
the other head dims of the bf16 route, the VAE's mid-block attention at
512^2 and 1024^2 in fp32 and in bf16, the UNet's fp32 self-attentions of
--mixed_precision no, the FMA route's other head dims, 128-448), one
JSON line a shape: device ms a call (CUDA events
around calls queued behind a device sleep) and the wrapper's host µs a
call (no synchronise inside), then the host µs a call of each part of
the wrapper at the image path's shape (``k1_host_parts``). ``--k4`` does the same for K4's wrapper
(``ops.flash_attention.flash_attention_bwd``: its delta, dk/dv and dq
kernels) at the train step's bf16 shapes, a ragged length and fp32 at
both levels; both also at stage 1's batch-1 levels in bf16 and fp32. Each fp32 row also holds the device ms of
``scaled_dot_product_attention`` (K1: its forward, K4: its backward) and,
the first time in a process, the names of its kernels;
``--k2`` for K2's wrapper (``ops.geglu.geglu_fwd``) at the paths' shapes
in bf16 and fp32, each row with the device ms of the three PyTorch
calls K2 fuses (``F.linear`` over the fused weight, ``F.gelu``, the
product) and of ``F.linear`` alone, readings of cuBLAS's rate;
``--k2_restarts`` builds copies of ``csrc/geglu.cu`` whose fp32 kernel
restarts its tensor-core sums every 8, 16 or 32 K values and reads each
copy's time and its largest distance from the plain version in fp32 and
in float64 at the fp32 path shapes; ``--k7`` times K7's wrapper
(``ops.layer_norm.layer_norm_fwd``) at the serving step's LayerNorm
shapes, each row with ``F.layer_norm``'s device ms;
``--k3`` for K3's wrapper (``ops.temporal_attention.temporal_attention_fwd``)
at every shape the paths give it (the serving path's motion levels at 16
frames in bf16 and fp32, stage 2's at 8, level 2 at 32 frames in both),
each row with its bandwidth bound and the device ms and kernel names of
``scaled_dot_product_attention`` on the same (N, H, F, d) views;
``--k3_cutouts`` times K3's wrapper at the same shapes against three
copies of ``csrc/temporal_attention.cu`` built apart (``k3_cut_source``):
as it is, with its loads and stores alone, and with its compute on data
that stays in L2; the same call times an older checkout's K3.
``--k5`` for K5's wrapper (``ops.temporal_attention.temporal_attention_bwd``)
at the stage-2 path's shapes (8 frames, each motion level in bf16, level
0 in fp32, and at the precision check's 2 frames) and at 32 frames at
each dtype's widest head, each row with its bound and the device ms and
kernel names of ``scaled_dot_product_attention``'s backward (a shape the
wrapper refuses reads ``refused``); ``--k5_cutouts`` times its cut-out
copies as ``--k3_cutouts`` does K3's (``k5_cut_source``, the macro
``VST_K5_CUTOUT``). ``--k4`` ends with the sliced routes' shapes
(d = 128-512, bf16 and fp32, each row with SDPA's backward);
``--k4_cutouts`` times those rows against copies of the flash-attention
sources built apart with ``-DVST_K4_CUTOUT`` (``k4_cut_entries``): whole,
with the sliced kernels' loads and stores alone, with their compute on
data that stays in L2, and (bf16 from d = 192 up) without the exchange of
S and dP shares between the blocks of a cluster.

``--precision`` holds the first stage-2 step (2 frames by default) in bf16
against fp32 on the same weights and draws, and the fp32 step against
itself with the noise nudged by 2^-20, on the trainer's seeded weights or
with ``--unziplora_name_or_path DIR`` on a stage-1 artifact set; one JSON
line of readings (``precision_readings``).

    python -m video_style_transfer_tpu_torch.cli.profile_step \\
        [--train | --image | --decode | --k1 | --k2 | --k2_restarts | --k3 |
         --k3_cutouts | --k4 | --k4_cutouts | --k5 |
         --k5_cutouts | --k7 | --precision]
        [--mixed_precision bf16|no] [--vae_dtype float32|bfloat16]
        [--num_frames N] [--resolution 1024] [--steps N]
        [--unziplora_name_or_path DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import time
import types

import torch

# first match wins: cuDNN's convolutions are implicit GEMMs by name
CATEGORIES = (
    ("K1 flash_attention_fwd (wgmma)", ("flash_fwd_sm90_",)),
    ("K1 flash_attention_fwd (fma)", ("flash_fwd_f32_kernel",)),
    ("K1 flash_attention_fwd (kv-split combine)", ("flash_combine_kernel",)),
    ("K1 flash_attention_fwd (tf32x3)", ("flash_fwd_tf32_kernel",)),
    ("K2 geglu_projection", ("geglu_bf16_kernel", "geglu_f32_kernel",
                             "geglu_split_w_kernel")),
    ("K3 temporal_attention", ("ta_fwd_mma_kernel",)),
    ("K4 flash_attention_bwd", ("flash_bwd_dkv", "flash_bwd_dq",
                                "flash_bwd_delta")),
    ("K5 temporal_attention_bwd", ("ta_bwd_mma_kernel",)),
    ("K7 layer_norm", ("::layer_norm_kernel",)),
    ("layer_norm (library)", ("layer_norm", "layernorm")),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "winograd")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _serving_phases(args, dev):
    """[("cfg_denoise", fn)]: one CFG denoise call, warmed up."""
    from video_style_transfer_tpu_torch.cli import common
    from video_style_transfer_tpu_torch.pipelines.sampling import (
        make_cfg_denoiser)

    # the UNet's dtype as cli.infer_video picks it
    dtype = torch.float32 if args.mixed_precision == "no" else torch.bfloat16
    with torch.inference_mode():
        bundle = common.load_models(None, motion=not args.image,
                                    dtype=dtype, device=dev)
        res, f = args.resolution, args.num_frames
        uncond = common.negative_conditioning(
            bundle, common.DEFAULT_NEGATIVE_PROMPT, height=res, width=res)
        cond = common.make_conditioning(bundle, "a horse", height=res,
                                        width=res)
        eps_fn = make_cfg_denoiser(bundle.unet, bundle.unet_cfg, uncond,
                                   cond, cfg_scale=7.5, num_frames=f,
                                   dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(f, res // 8, res // 8, 4, generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        t = torch.tensor(958.0, device=dev)

    def denoise():
        with torch.inference_mode():
            eps_fn(x, t)
    denoise()
    return [("cfg_denoise", denoise)], {"cfg_rows": 2 * args.num_frames,
                                        "unet_dtype": str(dtype)[6:]}


def _decode_phases(args, dev):
    """[("vae_decode", fn)]: the VAE decode of one frame's latents in
    --vae_dtype (SDXL's decoder, seeded random weights, cast once as
    ``pipelines.video.decode_video`` casts it), warmed up."""
    from video_style_transfer_tpu_torch.cli import common
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.vae import init_vae_decoder
    from video_style_transfer_tpu_torch.pipelines.video import decode_video
    from video_style_transfer_tpu_torch.utils.convert import to_device

    vcfg = common.model_configs(smoke=False, motion=True)[1]
    dtype = getattr(torch, args.vae_dtype)
    with torch.inference_mode():
        vae = to_device(init_vae_decoder(Init(1, dev), vcfg), dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        lat = args.resolution // 8
        z = torch.randn(1, lat, lat, vcfg.latent_channels, generator=gen,
                        device=dev)

    def decode():
        with torch.inference_mode():
            decode_video(vae, vcfg, z, chunk=1, dtype=dtype)
    decode()
    return [("vae_decode", decode)], {"frames": 1,
                                      "vae_dtype": args.vae_dtype}


def _train_phases(args, dev):
    """[("stage2_encode", fn), ("stage2_train", fn)]: the fp32 VAE encode
    of one synthetic clip and one train step on it, warmed up."""
    from video_style_transfer_tpu_torch.cli import train_animatediff as ta

    targs = ta.build_parser().parse_args([
        "--prompt", "a horse galloping", "--num_frames", str(args.num_frames),
        "--resolution", str(args.resolution),
        "--lr_warmup_steps", "1", "--max_train_steps", "1000",
        "--device", str(dev)])
    tr = ta.prepare(targs)
    micro = []

    def encode():
        micro[:] = ta.sample_micro_batches(tr)

    def train():
        tr.step(tr.params, micro, tr.generator)
    encode()
    train()
    return ([("stage2_encode", encode), ("stage2_train", train)],
            {"train_rows": tr.batch * tr.frames,
             "trainable_params": sum(t.numel() for _, t in tr.trainable)})


def _cast_tree(tree, dtype):
    """A copy of a tree of dicts and lists with every floating tensor in
    `dtype` (others as they are)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    if hasattr(tree, "is_floating_point") and tree.is_floating_point():
        return tree.detach().to(dtype)
    return tree


def precision_readings(train_argv):
    """The first stage-2 step's loss and trainable gradients in bf16 (the
    trainer's precision) against fp32 on the same weights (the bf16 tree
    cast up), batch and draws; and the fp32 step's own sensitivity, the
    same step with the noise scaled by 1 + 2^-20, which says whether the
    weights are conditioned well enough for a precision to show. `train_argv`: the trainer's
    arguments (``cli.train_animatediff``). Returns a dict of readings."""
    import math

    from video_style_transfer_tpu_torch.cli import train_animatediff as ta
    from video_style_transfer_tpu_torch.lora.surgery import spatial_pairs
    from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
    from video_style_transfer_tpu_torch.training import stage2

    targs = ta.build_parser().parse_args(train_argv)
    tr = ta.prepare(targs)
    batch = ta.sample_micro_batches(tr)[0]
    sched = make_schedule()
    draws = stage2.draw_stage2(sched, tuple(batch["latents"].shape),
                               cfg_dropout=targs.cfg_dropout,
                               generator=tr.generator, device=tr.device)
    mask = stage2.trainable_mask(tr.params)
    cfg, params, state = tr.bundle.unet_cfg, tr.params, tr.lora_state
    del tr  # the models and optimizer of the bf16 trainer

    def step(params, state, dtype, draws):
        trainable = stage2.split_trainable(params, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = stage2.stage2_loss(
            params, cfg, sched, batch, draws, pairs=spatial_pairs(params),
            lambda_orth=targs.lambda_orth,
            prediction_type=targs.prediction_type, mode="both",
            state=state, dtype=dtype)
        loss.backward()
        grads = [t.grad.float() for _, t in trainable]
        torch.cuda.synchronize()
        for _, t in trainable:
            t.grad = None
        return loss.item(), grads, time.perf_counter() - t0

    def norm(a):
        return math.sqrt(sum(float(x.double().square().sum()) for x in a))

    def normwise(a, b):
        return norm([x - y for x, y in zip(a, b)]) / norm(b)

    torch.cuda.reset_peak_memory_stats()
    loss16, g16, s16 = step(params, state, torch.bfloat16, draws)
    params, state = (_cast_tree(params, torch.float32),
                     _cast_tree(state, torch.float32))
    loss32, g32, s32 = step(params, state, torch.float32, draws)
    nudged = {**draws, "noise": draws["noise"] * (1 + 2 ** -20)}
    loss32n, g32n, _ = step(params, state, torch.float32, nudged)
    return {
        "loss_bf16": loss16, "loss_fp32": loss32,
        "loss_rel_diff": abs(loss16 - loss32) / abs(loss32),
        "grad_norm_bf16": norm(g16), "grad_norm_fp32": norm(g32),
        "grad_normwise_err": normwise(g16, g32),
        "fp32_sensitivity_loss": abs(loss32n - loss32) / abs(loss32),
        "fp32_sensitivity_grad": normwise(g32n, g32),
        "tensors": len(g32),
        "finite": all(map(math.isfinite, (loss16, loss32))) and all(
            bool(torch.isfinite(g).all()) for g in g16 + g32),
        "step_s_bf16": s16, "step_s_fp32": s32,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# (tag, (B, S, H, D), dtype): K1's shapes in chip_smoke.py's K1 phases
K1_SHAPES = (("serving L2", (32, 1024, 20, 64), torch.bfloat16),
             ("serving L1", (32, 4096, 10, 64), torch.bfloat16),
             ("image L2", (2, 1024, 20, 64), torch.bfloat16),
             ("train L1", (8, 4096, 10, 64), torch.bfloat16),
             ("ragged", (2, 4032, 10, 64), torch.bfloat16),
             ("d128", (2, 4096, 10, 128), torch.bfloat16),
             ("K6 d192", (2, 4096, 2, 192), torch.bfloat16),
             ("d256", (2, 4096, 5, 256), torch.bfloat16),
             ("VAE 512^2", (1, 4096, 1, 512), torch.float32),
             ("VAE 1024^2", (1, 16384, 1, 512), torch.float32),
             ("VAE 512^2", (1, 4096, 1, 512), torch.bfloat16),
             ("VAE 1024^2", (1, 16384, 1, 512), torch.bfloat16),
             ("serving L2", (32, 1024, 20, 64), torch.float32),
             ("serving L1", (32, 4096, 10, 64), torch.float32),
             ("train L1", (8, 4096, 10, 64), torch.float32),
             ("d128", (2, 4096, 10, 128), torch.float32),
             ("d192", (2, 4096, 2, 192), torch.float32),
             ("d256", (2, 4096, 5, 256), torch.float32),
             ("d320", (1, 4096, 1, 320), torch.float32),
             ("d384", (1, 4096, 1, 384), torch.float32),
             ("d448", (1, 4096, 1, 448), torch.float32),
             ("stage-1 L1", (1, 4096, 10, 64), torch.bfloat16),
             ("stage-1 L2", (1, 1024, 20, 64), torch.bfloat16),
             ("stage-1 L1", (1, 4096, 10, 64), torch.float32),
             ("stage-1 L2", (1, 1024, 20, 64), torch.float32))


# (tag, (B, S, H, D), dtype): K4's shapes in chip_smoke.py's K4 phases
K4_SHAPES = (("train L1", (8, 4096, 10, 64), torch.bfloat16),
             ("train L2", (8, 1024, 20, 64), torch.bfloat16),
             ("ragged", (2, 1100, 2, 64), torch.bfloat16),
             ("train L2", (8, 1024, 20, 64), torch.float32),
             ("train L1", (8, 4096, 10, 64), torch.float32),
             ("stage-1 L1", (1, 4096, 10, 64), torch.bfloat16),
             ("stage-1 L2", (1, 1024, 20, 64), torch.bfloat16),
             ("stage-1 L1", (1, 4096, 10, 64), torch.float32),
             ("stage-1 L2", (1, 1024, 20, 64), torch.float32))
# K4's sliced routes at chip_smoke.py's SLICED_SHAPES (d = 128-512), bf16
# ("wgmma_sliced") and fp32 ("tf32x3_sliced"): the VAE's mid-block
# attention at 1024^2 and 512^2 and one shape at each other head dim
K4_SLICED_SHAPES = tuple(
    (tag, shape, dtype) for dtype in (torch.bfloat16, torch.float32)
    for tag, shape in (("VAE 1024^2", (1, 16384, 1, 512)),
                       ("VAE 512^2", (1, 4096, 1, 512)),
                       ("d128", (2, 4096, 10, 128)),
                       ("d192", (2, 4096, 2, 192)),
                       ("d320", (1, 4096, 1, 320)),
                       ("d384", (1, 4096, 1, 384)),
                       ("d448", (1, 4096, 1, 448))))
K4_SHAPES += K4_SLICED_SHAPES

# (tag, (F, N, H, d), dtype): K3's shapes, every one a path launches:
# the serving path's three motion levels at 16 frames (bf16, and fp32
# under --mixed_precision no), stage 2's at 8 frames, and level 2 at 32
# frames (--num_frames 32)
K3_SHAPES = (("serving L0", (16, 32768, 8, 40), torch.bfloat16),
             ("serving L1", (16, 4096, 8, 80), torch.bfloat16),
             ("serving L2", (16, 1024, 8, 160), torch.bfloat16),
             ("serving L0", (16, 32768, 8, 40), torch.float32),
             ("serving L1", (16, 4096, 8, 80), torch.float32),
             ("serving L2", (16, 1024, 8, 160), torch.float32),
             ("stage-2 L0", (8, 16384, 8, 40), torch.bfloat16),
             ("stage-2 L1", (8, 4096, 8, 80), torch.bfloat16),
             ("stage-2 L2", (8, 1024, 8, 160), torch.bfloat16),
             ("32-frame L2", (32, 1024, 8, 160), torch.bfloat16),
             ("32-frame L2", (32, 1024, 8, 160), torch.float32))

# (tag, (F, N, H, d), dtype): K5's shapes: the stage-2 path's three
# motion levels at 8 frames in bf16 (level 0 in fp32 too, as under
# --mixed_precision no), level 0 at the precision check's 2 frames in
# fp32, and 32 frames at the widest head each dtype's K3 takes
# (temporal_attention.pair_fits)
K5_SHAPES = (("stage-2 L0", (8, 16384, 8, 40), torch.bfloat16),
             ("stage-2 L0", (8, 16384, 8, 40), torch.float32),
             ("stage-2 L1", (8, 4096, 8, 80), torch.bfloat16),
             ("stage-2 L2", (8, 1024, 8, 160), torch.bfloat16),
             ("stage2_fp32 L0", (2, 16384, 8, 40), torch.float32),
             ("32-frame widest", (32, 1024, 2, 600), torch.float32),
             ("32-frame widest", (32, 1024, 2, 1208), torch.bfloat16))

# (tag, (M, C), dtype): K2's shapes in chip_smoke.py's K2 phases (inner =
# 4 C): spatial and motion level 2 and level 1 at the serving path's 32
# rows, motion level 0, spatial level 2 at the image path's 2 rows; the
# first three in fp32 too (--mixed_precision no)
K2_SHAPES = (("spatial L2", (32768, 1280), torch.bfloat16),
             ("L1", (131072, 640), torch.bfloat16),
             ("motion L0", (524288, 320), torch.bfloat16),
             ("image L2", (2048, 1280), torch.bfloat16),
             ("spatial L2", (32768, 1280), torch.float32),
             ("L1", (131072, 640), torch.float32),
             ("motion L0", (524288, 320), torch.float32))

# (tag, (M, C), dtype): K7's shapes in chip_smoke.py's K7 phases: the
# serving step's LayerNorms at UNet levels 2 and 1 and motion level 0,
# the CLIP bigG encoder's (two prompts of 77 tokens), level 2 in fp32
K7_SHAPES = (("UNet L2", (32768, 1280), torch.bfloat16),
             ("UNet L1", (131072, 640), torch.bfloat16),
             ("motion L0", (524288, 320), torch.bfloat16),
             ("CLIP bigG", (154, 1280), torch.bfloat16),
             ("UNet L2", (32768, 1280), torch.float32))


def _time_calls(fn, runs: int):
    """(device ms, host µs) a call of fn, each the median of `runs` runs
    of 20 calls."""
    fn()
    dev_ms, host_us = [], []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        # the calls queue behind ~25 ms of device sleep, so the events
        # time the kernels alone even where the wrapper's host time
        # exceeds a kernel's
        torch.cuda._sleep(50_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_us.append((time.perf_counter() - t0) / 20 * 1e6)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append(start.elapsed_time(end) / 20)
    return sorted(dev_ms)[runs // 2], sorted(host_us)[runs // 2]


def _qkv(shape, dtype, gen):
    """q, k and v (B, S, H, D): strided views of one seeded fused
    projection."""
    b, s, h, d = shape
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=gen.device,
                      dtype=dtype)
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1)]


def k1_call(shape, dtype, gen):
    """A call of K1's wrapper on seeded (q, k, v) of `shape`."""
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    q, k, v = _qkv(shape, dtype, gen)
    return lambda: fa.flash_attention_fwd(q, k, v)


def k4_call(shape, dtype, gen):
    """A call of K4's wrapper on seeded (q, k, v) of `shape`, K1's out and
    lse and a seeded dO."""
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    q, k, v = _qkv(shape, dtype, gen)
    b, s, h, d = shape
    o, lse = fa.flash_attention_fwd(q, k, v)
    do = torch.randn(b, s, h * d, generator=gen, device=q.device,
                     dtype=q.dtype)
    return lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)


def _ta_qkv(shape, dtype, gen):
    """q, k and v (F, N, H, d): strided views of one seeded fused (F, N,
    3 H d) projection, as the motion module makes them."""
    f, n, h, d = shape
    qkv = torch.randn(f, n, 3 * h * d, generator=gen, device=gen.device,
                      dtype=dtype)
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1)]


def k3_call(shape, dtype, gen):
    """A call of K3's wrapper on seeded (q, k, v) of `shape`."""
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta
    q, k, v = _ta_qkv(shape, dtype, gen)
    return lambda: ta.temporal_attention_fwd(q, k, v)


def k3_yardsticks(shape, dtype, gen, runs: int):
    """K3's bound (its q, k, v read once and its output written once at
    3.35 TB/s; its flops are far below the ridge) and the device ms of
    scaled_dot_product_attention on the same (N, H, F, d) views, with the
    names of the kernels one call runs (a process's first profile lists
    them)."""
    import torch.nn.functional as F
    f, n, h, d = shape
    q, k, v = (t.permute(1, 2, 0, 3) for t in _ta_qkv(shape, dtype, gen))

    def fn():
        return F.scaled_dot_product_attention(q, k, v)
    ms = _time_calls(fn, runs)[0]
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    es = torch.tensor([], dtype=dtype).element_size()
    return {"bound_ms": 4 * f * n * h * d * es / 3.35e12 * 1e3,
            "sdpa_ms": ms, "sdpa_kernels": names}


# K3's cut-out copies: the kernel takes the cuts from its macro
# VST_TA_CUTOUT; the shared-memory kernel it replaced (ta_fwd_kernel, a
# few pairs a block, no such macro) is cut by text at its phase
# boundaries: its compute runs between its two block barriers, and each
# block finds its pairs from pair0
K3_CUTS = ("whole", "load+store", "resident")
_OLD_COMPUTE = ("  // thread -> (pair pl, frame f, share s)",
                "  __syncthreads();\n\n  T* o = static_cast<T*>(a.o);")
_OLD_PAIR = "const long long gp = pair0 + p;"


def k3_cut_source(src: str, cut: str) -> str:
    """The K3 source `src` with `cut` applied: "load+store" keeps its loads
    and stores alone, "resident" keeps its data in L2 (each block on one
    tile of its own; in the replaced kernel, block b on the pairs of block
    b mod 132, one block an SM of an H100)."""
    if cut == "whole":
        return src
    if "VST_TA_CUTOUT" in src:
        return f"#define VST_TA_CUTOUT {K3_CUTS.index(cut)}\n" + src
    if cut == "load+store":
        start = src.index(_OLD_COMPUTE[0])
        return src[:start] + src[src.index(_OLD_COMPUTE[1], start):]
    if src.count(_OLD_PAIR) != 2:
        raise ValueError("the K3 source has neither VST_TA_CUTOUT nor the "
                         "replaced kernel's phase boundaries")
    return src.replace(_OLD_PAIR, "const long long gp = (long long)"
                                  "(blockIdx.x % 132) * pairs + p;")


def variant_entries(entry: str, sources: dict, work_name: str) -> dict:
    """{key: the C entry point `entry` of a throwaway library built from
    the CUDA source text sources[key]}, every nvcc started together, in
    _build/`work_name` (headers from the package Python finds first)."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    work = cuda_build.BUILD_DIR / work_name
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, text in sources.items():
        path = work / f"{str(key).replace('+', '_')}.cu"
        path.write_text(text)
        so = path.with_suffix(".so")
        procs[key] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-shared", "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {key} copy\n{out}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = cuda_build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        entries[key] = fn
    return entries


def k3_cut_entries():
    """{cut: K3's C entry point in a throwaway library built from the cut
    csrc/temporal_attention.cu of the package Python finds first}."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "temporal_attention.cu").read_text()
    return variant_entries(
        "vst_temporal_attention_fwd",
        {cut: k3_cut_source(src, cut) for cut in K3_CUTS}, "k3_cutouts")


def k3_cutouts(dev, runs: int):
    """Yields {cut, shape, device_ms}: K3's wrapper timed at each of
    K3_SHAPES against each cut copy (the wrapper finds the copy's entry
    point as the library's)."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    try:
        for cut, fn in k3_cut_entries().items():
            cuda_build._lib = types.SimpleNamespace(
                vst_temporal_attention_fwd=fn)
            for row in kernel_calls(dev, runs, K3_SHAPES, k3_call):
                yield {"cut": cut, "shape": row["shape"],
                       "device_ms": row["device_ms"]}
    finally:
        cuda_build._lib = None


def k5_call(shape, dtype, gen):
    """A call of K5's wrapper on seeded (q, k, v) of `shape` and a seeded
    dO; None where the wrapper refuses the shape (a kernel that does not
    take it)."""
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta
    q, k, v = _ta_qkv(shape, dtype, gen)
    f, n, h, d = shape
    do = torch.randn(f, n, h * d, generator=gen, device=q.device,
                     dtype=dtype)
    try:
        ta.temporal_attention_bwd(q, k, v, do)
    except (RuntimeError, ValueError):
        return None
    return lambda: ta.temporal_attention_bwd(q, k, v, do)


def k5_yardsticks(shape, dtype, gen, runs: int):
    """K5's bound (the larger of its q, k, v, dO read once and dq, dk, dv
    written once at 3.35 TB/s, and the JAX cost estimate of 11 F^2 d
    flops a (pixel, head) pair at 989 TF/s bf16 or 67 TF/s fp32) and the
    device ms of scaled_dot_product_attention's backward on the same (N,
    H, F, d) data (its forward taken once through autograd), with the
    names of its kernels."""
    import torch.nn.functional as F
    f, n, h, d = shape
    es = torch.tensor([], dtype=dtype).element_size()
    peak = 989e12 if dtype == torch.bfloat16 else 67e12
    row = {"bound_ms": max(7 * f * n * h * d * es / 3.35e12,
                           11 * f * f * n * h * d / peak) * 1e3}
    q, k, v = (t.permute(1, 2, 0, 3).contiguous().requires_grad_()
               for t in _ta_qkv(shape, dtype, gen))
    try:
        o = F.scaled_dot_product_attention(q, k, v)
    except RuntimeError as e:
        return {**row, "sdpa_bwd_error": str(e).splitlines()[0]}
    go = torch.randn(o.shape, generator=gen, device=o.device, dtype=dtype)

    def fn():
        return torch.autograd.grad(o, (q, k, v), go, retain_graph=True)
    row["sdpa_bwd_ms"] = _time_calls(fn, runs)[0]
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        fn()
        torch.cuda.synchronize()
    row["sdpa_bwd_kernels"] = sorted(
        {e.name for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA})
    return row


# K5's cut-out copies: the kernel takes the cuts from its macro
# VST_K5_CUTOUT; the CUDA-core kernel it replaced (ta_bwd_kernel, a few
# pairs a block, no such macro) is cut by text: its compute runs between
# its load and store loops, and each block finds its pairs from pair0
K5_CUTS = ("whole", "load+store", "resident")
_OLD_K5_COMPUTE = ("  // thread -> (pair pl, frame row r, share s)",
                   "  __syncthreads();\n\n  T* dq = static_cast<T*>(a.dq);")
_OLD_K5_PAIR = "const long long pair0 = (long long)blockIdx.x * pairs;"


def k5_cut_source(src: str, cut: str) -> str:
    """The K5 source `src` with `cut` applied: "load+store" keeps its loads
    and stores alone (what it stores is not the gradients), "resident"
    keeps its data in L2 (each block on one tile of its own; in the
    replaced kernel, block b on the pairs of block b mod 132, one block an
    SM of an H100)."""
    if cut == "whole":
        return src
    if "VST_K5_CUTOUT" in src:
        return f"#define VST_K5_CUTOUT {K5_CUTS.index(cut)}\n" + src
    if cut == "load+store":
        start = src.index(_OLD_K5_COMPUTE[0])
        return src[:start] + src[src.index(_OLD_K5_COMPUTE[1], start):]
    if src.count(_OLD_K5_PAIR) != 1:
        raise ValueError("the K5 source has neither VST_K5_CUTOUT nor the "
                         "replaced kernel's pair origin")
    return src.replace(_OLD_K5_PAIR, "const long long pair0 = (long long)"
                                     "(blockIdx.x % 132) * pairs;")


def k5_cut_entries():
    """{cut: K5's C entry point in a throwaway library built from the cut
    csrc/temporal_attention_bwd.cu of the package Python finds first}."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "temporal_attention_bwd.cu").read_text()
    return variant_entries(
        "vst_temporal_attention_bwd",
        {cut: k5_cut_source(src, cut) for cut in K5_CUTS}, "k5_cutouts")


def k5_cutouts(dev, runs: int):
    """Yields {cut, shape, device_ms}: K5's wrapper timed at each of
    K5_SHAPES against each cut copy (the wrapper finds the copy's entry
    point as the library's; None where the copy refuses the shape)."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    try:
        for cut, fn in k5_cut_entries().items():
            cuda_build._lib = types.SimpleNamespace(
                vst_temporal_attention_bwd=fn)
            for row in kernel_calls(dev, runs, K5_SHAPES, k5_call):
                yield {"cut": cut, "shape": row["shape"],
                       "device_ms": row["device_ms"]}
    finally:
        cuda_build._lib = None


# K4's cut-out copies: the sliced kernels take the cuts from the macro
# VST_K4_CUTOUT (csrc/flash_attention_bwd_sliced.cu and the sliced kernels
# of csrc/flash_attention_tf32.cu); "no-exchange" skips the bf16 kernels'
# exchange of S and dP shares between the blocks of a cluster (wrong
# gradients; the fp32 kernels have none, and run whole)
K4_CUTS = ("whole", "load+store", "resident", "no-exchange")


def k4_cut_entries():
    """{cut: K4's C entry point in a throwaway library built from the
    flash-attention sources (csrc/flash_attention*.cu) of the package
    Python finds first with -DVST_K4_CUTOUT=<the cut's index>, every nvcc
    started together, in _build/k4_cutouts/<cut>}."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    srcs = sorted(cuda_build.CSRC.glob("flash_attention*.cu"))
    if "VST_K4_CUTOUT" not in (cuda_build.CSRC /
                               "flash_attention_bwd_sliced.cu").read_text():
        raise ValueError("the sliced K4 source has no VST_K4_CUTOUT")
    builds = {}
    for i, cut in enumerate(K4_CUTS):
        work = cuda_build.BUILD_DIR / "k4_cutouts" / cut.replace("+", "_")
        work.mkdir(parents=True, exist_ok=True)
        objs = [(work / (src.stem + ".o"), subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
             f"-DVST_K4_CUTOUT={i}", "-I", str(cuda_build.CSRC), "-c",
             str(src), "-o", str(work / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in srcs]
        builds[cut] = (work, objs)
    entries = {}
    for cut, (work, objs) in builds.items():
        for obj, proc in objs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the {cut} copy\n{out}")
        so = work / "libk4_cut.so"
        link = subprocess.run(
            [cuda_build._nvcc(), "-shared", "-o", str(so),
             *[str(o) for o, _ in objs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the {cut} copy failed\n"
                               + link.stdout)
        lib = ctypes.CDLL(str(so))
        for name in ("vst_flash_attention_fwd", "vst_flash_attention_bwd",
                     "vst_flash_attention_bwd_delta"):
            getattr(lib, name).argtypes = cuda_build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        entries[cut] = lib
    return entries


def k4_cutouts(dev, runs: int):
    """Yields {cut, shape, device_ms}: K4's wrapper timed at each of
    K4_SLICED_SHAPES against each cut copy of the sliced kernels (the
    wrapper finds the copy's library as its own; the forward that makes
    the inputs runs from the same copy, uncut)."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    try:
        for cut, lib in k4_cut_entries().items():
            cuda_build._lib = lib
            for row in kernel_calls(dev, runs, K4_SLICED_SHAPES, k4_call):
                yield {"cut": cut, "shape": row["shape"],
                       "device_ms": row["device_ms"]}
    finally:
        cuda_build._lib = None


def _geglu_inputs(shape, dtype, gen):
    """Seeded x (M, C), W (2 inner, C) and b (2 inner,), inner = 4 C."""
    m, c = shape
    inner = 4 * c

    def randn(*size, scale=1.0):
        return (torch.randn(*size, generator=gen, device=gen.device) *
                scale).to(dtype)
    return randn(m, c), randn(2 * inner, c, scale=c ** -0.5), randn(
        2 * inner, scale=0.1)


def k2_call(shape, dtype, gen):
    """A call of K2's wrapper on seeded (x, W, b) of `shape`, in the gate
    the models use at `dtype`."""
    from video_style_transfer_tpu_torch.ops import geglu
    x, w, b = _geglu_inputs(shape, dtype, gen)
    gate = geglu._default_gate_for(dtype)
    return lambda: geglu.geglu_fwd(x, w, b, gate)


def geglu_yardsticks(shape, dtype, gen, runs: int):
    """Device ms a call of the three PyTorch calls K2 fuses and of
    F.linear alone (cuBLAS; fp32 with TF32 off), on seeded inputs of
    `shape`."""
    import torch.nn.functional as F
    x, w, b = _geglu_inputs(shape, dtype, gen)

    def three_calls():
        h, g = F.linear(x, w, b).chunk(2, dim=-1)
        return h * F.gelu(g)
    return {"three_calls_ms": _time_calls(three_calls, runs)[0],
            "linear_ms": _time_calls(lambda: F.linear(x, w, b), runs)[0]}


def sdpa_yardstick(shape, dtype, gen, runs: int, backward: bool = False):
    """Device ms a call of scaled_dot_product_attention (its backward
    alone with `backward`) on seeded fp32 (q, k, v) of `shape`, and the
    names of the kernels one call runs (torch.profiler; only a process's
    first profile lists them): the library's fp32 arithmetic, read from
    its kernels' names. None for bf16, but for the backward at d > 64
    (the sliced routes' yardstick)."""
    import torch.nn.functional as F
    if dtype != torch.float32 and not (backward and shape[3] > 64):
        return {}
    q, k, v = (t.transpose(1, 2) for t in _qkv(shape, dtype, gen))
    if backward:
        q, k, v = (t.contiguous().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(q, k, v)
        go = torch.randn(o.shape, generator=gen, device=o.device,
                         dtype=dtype)

        def fn():
            return torch.autograd.grad(o, (q, k, v), go, retain_graph=True)
    else:
        def fn():
            return F.scaled_dot_product_attention(q, k, v)
    ms = _time_calls(fn, runs)[0]
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    return {"sdpa_ms": ms, "sdpa_kernels": names}


# K2's fp32 restart lengths (K values whose tensor-core products are
# summed from zero before an f32 add) that --k2_restarts builds
K2_RESTARTS = (8, 16, 32)


def k2_restart_entries():
    """{restart: K2's C entry point in a throwaway library built from
    csrc/geglu.cu of the package Python finds first, with its fp32
    kernel's RESTART set to restart / 8 K steps}."""
    import re

    from video_style_transfer_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / "geglu.cu").read_text()
    pattern = r"static constexpr int RESTART = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise ValueError("csrc/geglu.cu states no fp32 restart length")
    return variant_entries(
        "vst_geglu_fwd",
        {restart: re.sub(pattern, f"static constexpr int RESTART = "
                                  f"{restart // 8};", src)
         for restart in K2_RESTARTS}, "k2_restarts")


def k2_restarts(dev, runs: int):
    """Yields {restart, shape, device_ms, vs_fp32_plain, vs_float64}: K2's
    wrapper at each fp32 shape of K2_SHAPES against each restart copy,
    with its largest distance from the plain version in fp32 (cuBLAS's
    fp32 GEMM, TF32 off) and on float64 copies of the same inputs."""
    from video_style_transfer_tpu_torch.ops import cuda_build, geglu
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = k2_restart_entries()
    try:
        for tag, shape, dtype in K2_SHAPES:
            if dtype != torch.float32:
                continue
            x, w, b = _geglu_inputs(shape, dtype, gen)
            ref = geglu.geglu_plain(x, w, b, "erf5")
            ref64 = geglu.geglu_plain(x.double(), w.double(), b.double(),
                                      "erf5")
            yield {"restart": None, "shape": f"{tag} {shape} float32",
                   "fp32_plain_vs_float64":
                       (ref.double() - ref64).abs().max().item()}
            for restart, fn in entries.items():
                cuda_build._lib = types.SimpleNamespace(vst_geglu_fwd=fn)
                out = geglu.geglu_fwd(x, w, b, "erf5")
                row = {"restart": restart, "shape": f"{tag} {shape} float32",
                       "vs_fp32_plain": (out - ref).abs().max().item(),
                       "vs_float64":
                           (out.double() - ref64).abs().max().item()}
                del out
                row["device_ms"] = _time_calls(
                    lambda: geglu.geglu_fwd(x, w, b, "erf5"), runs)[0]
                yield row
            del x, w, b, ref, ref64
            torch.cuda.empty_cache()
    finally:
        cuda_build._lib = None


def k7_call(shape, dtype, gen):
    """A call of K7's wrapper on seeded (x, w, b) of `shape` (the scales
    of chip_smoke.py's K7 phases)."""
    from video_style_transfer_tpu_torch.ops import layer_norm as ln
    x, w, b = _ln_inputs(shape, dtype, gen)
    return lambda: ln.layer_norm_fwd(x, w, b)


def _ln_inputs(shape, dtype, gen):
    m, c = shape

    def randn(*size, scale=1.0, shift=0.0):
        return (torch.randn(*size, generator=gen, device=gen.device) *
                scale + shift).to(dtype)
    return (randn(m, c, scale=1.5, shift=0.3),
            randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1))


def layer_norm_yardstick(shape, dtype, gen, runs: int):
    """Device ms a call of F.layer_norm on seeded inputs of `shape`."""
    import torch.nn.functional as F
    x, w, b = _ln_inputs(shape, dtype, gen)
    return {"layer_norm_ms": _time_calls(
        lambda: F.layer_norm(x, (shape[1],), w, b, 1e-5), runs)[0]}


def kernel_calls(dev, runs: int, shapes, make_call, yardsticks=None):
    """Yields {shape, device_ms, host_us} for the call make_call(shape,
    dtype, gen) builds at each (tag, shape, dtype) of `shapes` (None where
    it builds none: the wrapper refuses the shape), with the readings of
    yardsticks(shape, dtype, gen, runs) where given, each as soon as it is
    measured."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, shape, dtype in shapes:
        call = make_call(shape, dtype, gen)
        row = {"shape": f"{tag} {shape} {str(dtype)[6:]}"}
        if call is None:
            row.update(device_ms=None, host_us=None, refused=True)
        else:
            row["device_ms"], row["host_us"] = _time_calls(call, runs)
        if yardsticks is not None:
            row.update(yardsticks(shape, dtype, gen, runs))
        yield row
        torch.cuda.empty_cache()


def k1_host_parts(dev, runs: int):
    """Host µs a call of each part of K1's wrapper at the image path's L2
    shape (2,1024,20x64) bf16, each the median of `runs` runs of 100 calls
    queued behind a device sleep: the layout check, the two output
    allocations, entering the device context, the stream lookup and the
    whole wrapper (the rest of which is the C call: its argument
    marshalling, tensor maps, shared-memory attribute and launch)."""
    from video_style_transfer_tpu_torch.ops import cuda_build
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    b, s, h, d = 2, 1024, 20, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))

    def device_context():
        with torch.cuda.device(q.device):
            pass

    parts = {
        "_check": lambda: fa._check(q, k, v),
        "torch.empty x2": lambda: (
            torch.empty((b, s, h * d), dtype=q.dtype, device=dev),
            torch.empty((b, h, s), dtype=torch.float32, device=dev)),
        "torch.cuda.device": device_context,
        "stream_of": lambda: cuda_build.stream_of(q),
        "wrapper": lambda: fa.flash_attention_fwd(q, k, v)}
    result = {}
    for name, fn in parts.items():
        fn()
        us = []
        for _ in range(runs):
            torch.cuda.synchronize()
            torch.cuda._sleep(50_000_000)
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            us.append((time.perf_counter() - t0) / 100 * 1e6)
        result[name] = sorted(us)[runs // 2]
    torch.cuda.synchronize()
    return {"shape": f"image L2 {(b, s, h, d)} bfloat16", "host_us": result}


def _host_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def trace(fn, top: int):
    """Run fn once without and once under the profiler; returns the
    summary of the traced run."""
    torch.cuda.reset_peak_memory_stats()
    untraced_s = _host_seconds(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        traced_s = _host_seconds(fn)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device kernels")
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.device_time_total
        c = by_cat.setdefault(category(e.name), [0.0, 0])
        c[0] += us / 1e3
        c[1] += 1
        n = by_name.setdefault(e.name[:120], [0.0, 0])
        n[0] += us / 1e3
        n[1] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "step_host_s": traced_s, "untraced_host_s": untraced_s,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "kernel_ms_total": sum(v[0] for v in by_cat.values()),
        "device_busy_ms": busy / 1e3, "device_window_ms": window / 1e3,
        "device_idle_share": 1.0 - busy / window,
        "by_category": {k: {"ms": v[0], "launches": v[1]}
                        for k, v in sorted(by_cat.items(),
                                           key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": k, "ms": v[0], "launches": v[1]}
                        for k, v in ranked]}


def main(argv=None):
    from video_style_transfer_tpu_torch.cli import common

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_frames", type=int, default=None,
                   help="16 for serving, 8 for --train")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--train", action="store_true",
                   help="trace a stage-2 clip encode and train step")
    p.add_argument("--image", action="store_true",
                   help="trace the image path's denoise call (one image, "
                        "no motion modules)")
    p.add_argument("--decode", action="store_true",
                   help="trace the VAE decode of one frame")
    p.add_argument("--vae_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="--decode: the VAE's dtype (the CLIs' --vae_dtype)")
    p.add_argument("--k1", action="store_true",
                   help="time K1's wrapper alone at the paths' shapes")
    p.add_argument("--k2", action="store_true",
                   help="time K2's wrapper alone at the paths' shapes")
    p.add_argument("--k2_restarts", action="store_true",
                   help="time K2's fp32 kernel at each restart length, with "
                        "its distance from the plain version")
    p.add_argument("--k3", action="store_true",
                   help="time K3's wrapper alone at the paths' shapes")
    p.add_argument("--k3_cutouts", action="store_true",
                   help="time K3 whole, with its loads and stores alone and "
                        "with its compute on resident data")
    p.add_argument("--k5", action="store_true",
                   help="time K5's wrapper alone at the stage-2 shapes and "
                        "32 frames at the widest head")
    p.add_argument("--k5_cutouts", action="store_true",
                   help="time K5 whole, with its loads and stores alone and "
                        "with its compute on resident data")
    p.add_argument("--k4", action="store_true",
                   help="time K4's wrapper alone at the train step's "
                        "shapes and the sliced routes' (d = 128-512)")
    p.add_argument("--k4_cutouts", action="store_true",
                   help="time K4's sliced kernels whole, with their loads "
                        "and stores alone, with their compute on resident "
                        "data and without their cluster exchange")
    p.add_argument("--k7", action="store_true",
                   help="time K7's wrapper alone at the serving step's "
                        "LayerNorm shapes")
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["bf16", "no"],
                   help="the serving phase's UNet dtype (no: fp32, as "
                        "cli.infer_video --mixed_precision no)")
    p.add_argument("--precision", action="store_true",
                   help="hold the first stage-2 step in bf16 against fp32 "
                        "(default 2 frames)")
    p.add_argument("--unziplora_name_or_path", default=None,
                   help="--precision: the stage-1 artifact set the "
                        "trainer loads (default: its seeded rank-4 LoRA)")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--steps", type=int, default=0,
                   help="time each phase this many times without the "
                        "profiler instead of tracing it")
    args = p.parse_args(argv)
    if args.num_frames is None:
        args.num_frames = (1 if args.image else 2 if args.precision
                           else 8 if args.train else 16)
    dev = common.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    if args.precision:
        argv = ["--prompt", "a horse galloping through a snowy forest",
                "--num_frames", str(args.num_frames), "--resolution",
                str(args.resolution), "--max_train_steps", "1",
                "--lr_warmup_steps", "1", "--device", str(dev),
                "--seed", "0"]
        if args.unziplora_name_or_path:
            argv += ["--unziplora_name_or_path", args.unziplora_name_or_path]
        print(json.dumps({"card": card, "package": common.__file__,
                          "step": "stage2_precision",
                          "num_frames": args.num_frames,
                          "resolution": args.resolution,
                          "unziplora": args.unziplora_name_or_path,
                          **precision_readings(argv)}), flush=True)
        return
    if args.k2_restarts:
        for row in k2_restarts(dev, max(args.steps, 5)):
            print(json.dumps({"card": card, "package": common.__file__,
                              "kernel": "K2 geglu_projection fp32", **row}),
                  flush=True)
        return
    if args.k3_cutouts:
        for row in k3_cutouts(dev, max(args.steps, 5)):
            print(json.dumps({"card": card, "package": common.__file__,
                              "kernel": "K3 temporal_attention", **row}),
                  flush=True)
        return
    if args.k5_cutouts:
        for row in k5_cutouts(dev, max(args.steps, 5)):
            print(json.dumps({"card": card, "package": common.__file__,
                              "kernel": "K5 temporal_attention_bwd", **row}),
                  flush=True)
        return
    if args.k4_cutouts:
        for row in k4_cutouts(dev, max(args.steps, 5)):
            print(json.dumps({"card": card, "package": common.__file__,
                              "kernel": "K4 flash_attention_bwd", **row}),
                  flush=True)
        return
    if args.k1 or args.k2 or args.k3 or args.k4 or args.k5 or args.k7:
        kernel, shapes, make_call, yardsticks = (
            ("K7 layer_norm", K7_SHAPES, k7_call, layer_norm_yardstick)
            if args.k7
            else ("K5 temporal_attention_bwd", K5_SHAPES, k5_call,
                  k5_yardsticks) if args.k5
            else ("K4 flash_attention_bwd", K4_SHAPES, k4_call,
                  functools.partial(sdpa_yardstick, backward=True)) if args.k4
            else ("K3 temporal_attention", K3_SHAPES, k3_call,
                  k3_yardsticks) if args.k3
            else ("K2 geglu_projection", K2_SHAPES, k2_call,
                  geglu_yardsticks) if args.k2
            else ("K1 flash_attention_fwd", K1_SHAPES, k1_call,
                  sdpa_yardstick))
        for row in kernel_calls(dev, max(args.steps, 5), shapes, make_call,
                                yardsticks):
            print(json.dumps({"card": card, "package": common.__file__,
                              "kernel": kernel, **row}), flush=True)
        if args.k1:
            print(json.dumps({"card": card, "package": common.__file__,
                              "kernel": "K1 wrapper host parts",
                              **k1_host_parts(dev, max(args.steps, 5))}),
                  flush=True)
        return

    phases, extra = (_train_phases if args.train
                     else _decode_phases if args.decode
                     else _serving_phases)(args, dev)
    for name, fn in phases:
        if args.steps:
            result = {"card": card, "package": common.__file__,
                      "host_s": [_host_seconds(fn)
                                 for _ in range(args.steps)]}
        else:
            result = trace(fn, args.top)
        print(json.dumps({
            "device": torch.cuda.get_device_name(0), "step": name,
            "num_frames": args.num_frames, "resolution": args.resolution,
            **extra, **result}), flush=True)


if __name__ == "__main__":
    main()
