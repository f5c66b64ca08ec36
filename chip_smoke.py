#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   video_style_transfer_tpu_torch/csrc/ and prints the build time.
2. Holds each kernel against its plain PyTorch version at the shapes of
   the serving, stage-2 training and image paths, in bf16 and in fp32
   (TF32 off), and times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call (the yardstick
   only; the port never calls it): K1-K3 forward, K4-K5 backward, K1's
   d=192 instance, which stands for the JAX package's unpacked kernel
   (K6), and the one-pass LayerNorm (K7), which no model calls, at the
   LayerNorm shapes of the serving path. K1 has three routes (`route` in
   ops/flash_attention.py): bf16 on wgmma + TMA (d <= 256 one kernel,
   d >= 320 (the VAE under --vae_dtype bfloat16) the wide kernel, O split
   across two consumer warpgroups), fp32 at d = 64 (the UNet under
   --mixed_precision no) on mma.sync at 3xTF32, every other fp32 head dim
   (d = 512: the VAE; 128-448 on no path) on FP32 FMA register tiles, one
   template on d; its phases hold out and lse, the VAE's at the 512^2 and
   the 1024^2 paths' token counts (4096 and 16384) in fp32 and in bf16,
   the FMA route at every head dim, and, like the backward and K7
   phases, refuse two faulty copies of the outputs; the 3xTF32 phases
   also print both bounds (3 TF32 products a product on the tensor cores,
   and the FMA rate). K2 has two routes (`route` in ops/geglu.py): bf16
   on wgmma + TMA (persistent, clusters of two blocks sharing W by
   multicast), fp32 on TF32 wgmma at 3xTF32; both are held at the FF
   shapes of the paths the same way (bf16 normwise too; fp32 against the
   plain version on float64 copies of the inputs, its distance from the
   fp32 plain version reported beside) with both bounds printed for
   fp32; its yardstick is three PyTorch calls (F.linear over the fused
   weight, the gate, the product), and F.linear alone is timed as a
   reading of cuBLAS's rate. K3 (mma.sync on the tensor
   cores, fp32 at 3xTF32, fed by TMA) is held the same way (bf16 normwise
   too) at the serving path's three motion levels in bf16 and fp32, stage
   2's at 8 frames and 32-frame clips at level 2 in both, each phase with
   its share of the bound and its time against SDPA's; K5 (its backward,
   the same design: mma.sync, fp32 at 3xTF32, TMA in and out) at stage
   2's three levels, level 0 in fp32 at 8 and at 2 frames (the
   stage2_fp32 path), and 32-frame clips at the widest head each dtype's
   K3 takes (taken in column chunks), against SDPA's backward; the build
   report fails if a K3 or K5 kernel spills. K4 has four routes
   (`bwd_route`): at d = 64 bf16 on wgmma + TMA, fp32 on mma.sync at
   3xTF32; at d = 128-512 the sliced kernels (`bwd_plan`: D split, bf16
   on wgmma + TMA across the blocks of a thread-block cluster, which sum
   their shares of S and dP through distributed shared memory, fp32 at
   3xTF32 across a block's warps);
   its d = 64 phases (the train step's two levels and a ragged length,
   each in bf16 and fp32) also print the bound at the two-kernel design's
   14 flops, its sliced phases (`sliced_phases`: the VAE's head at 16384
   and 4096 tokens and every other head dim, bf16 and fp32) the bound at
   the design's own count, SDPA's backward with its backend named, and
   two runs held bitwise equal; its delta kernel is held to the torch
   formula at every shape and timed beside torch.linalg.vecdot, one
   PyTorch call of the same function.
3. Holds the tiny pipeline, a tiny stage-2 training step, and the image
   and video CLIs on a synthetic checkpoint directory with LoRA and
   motion artifacts read from files, on the card against the same on the
   CPU (the plain versions); and the first full-width stage-2 step in
   bf16 against the same step in fp32 (2 frames at 1024^2), whose fp32
   steps are the training path of --mixed_precision no: every spatial
   self-attention on K1's and K4's 3xTF32 route and every feed-forward on
   K2's, counted by route.
4. Drives, at full SDXL + AnimateDiff-XL width and depth with seeded
   random weights, each with every kernel's launch counters set to 0
   just before and read just after:
   - the stage-2 trainer through ``cli.train_animatediff.train`` (8
     frames, 1024^2, bf16 UNet, fp32 VAE encode) on one seeded 10-frame
     1024^2 video held in memory: one epoch, its 3 clip starts, through
     the latent-moment cache (K1's FMA route runs once per encoded frame,
     the cache's misses), a checkpoint at step 2, then a run resumed from
     it to step 4 (restored tensors and optimizer state bitwise as saved,
     the committed checkpoints alone on disk, one metrics.jsonl line per
     logged step), which writes the motion checkpoint; then three 8-bit
     AdamW steps over the trained tensors on the card and on the CPU from
     the same gradients (codes equal, scales and tensors within 1e-6, the
     state smaller than fp32 moments);
   - the stage-1 trainer through ``cli.train_unziplora.train``
     (``stage1_path``: rank 64, 1024^2, bf16 UNet, the reference's
     learning rates, two seeded instance images and two content class
     images held in memory): run A, 8 steps of the column separation
     through every phase with a checkpoint, validation and the export;
     run B, resumed from its step-4 checkpoint (restored state bitwise as
     saved, the phases run A's, the re-imported artifacts bitwise the
     trained tensors); the selection arithmetic from run A's
     selection-step gradients on the card, and from those gradients
     scaled past the threshold on the card against the CPU; run F, one
     zero-out step resumed from a checkpoint holding that scaled
     selection (partial masks: mergers gated by them, the exported up
     tensors partly zeroed and read back bitwise); run C, two fp32 steps
     (K1, K4 and K2 on tf32x3); two steps each of 8-bit AdamW and Prodigy;
   - the serving path through ``cli.infer_video.generate`` (16 frames,
     1024^2, CFG 7.5, 2 steps, bf16 UNet, fp32 VAE decode) in the modes
     base, both, content and style, from a rank-64 UnZipLoRA artifact set
     on disk and the motion checkpoint the trainer just wrote;
   - the image path through ``cli.infer.generate`` (1024^2, CFG 5, 3
     DPM-Solver++ steps, mode both with distinct content and style
     prompts, the same artifact set);
   - the bf16 VAE decode that ``--vae_dtype bfloat16`` gives
     (``pipelines.video.decode_video`` on 16 seeded 128^2 latent frames,
     the full-width SDXL decoder with seeded weights), held within mean
     3 and p99 16 uint8 levels of the fp32 decode of the same latents;
   - gradients through the full-width SDXL VAE (``vae_grad_path``): one
     1024^2 frame through ``models.vae.vae_decode`` in fp32 and bf16 and
     ``vae_encode`` in fp32, the input's and the mid attention's
     projection weights' gradients held (VAE_GRAD_LIMITS) against the
     same call with that attention on the plain route; K4 once a call on
     its sliced route, peak memory printed;
   - two processes on the one card (``multi_process_section``), each in
     a gloo process group this script sets up on cuda:0 (NCCL refuses
     two ranks on one device): a probe of gloo's collectives on CUDA
     tensors, then through the CLIs' entry points ``cli.infer_video
     --frame_parallel 2`` (the serving configuration above, mode both),
     ``cli.train_animatediff --frame_parallel 2`` at 512^2 (SDXL's
     widths, 8 frames: 2 steps with a checkpoint after each, then a run
     resumed from checkpoint-1, restored bitwise) and
     ``cli.train_unziplora --data_parallel 2`` at one row a process (2
     steps through a selection from gradients scaled by run D's factor,
     then run D's selection on each rank, which must give run D's
     masks), each held against one process: serving also runs in fp32
     (--mixed_precision no) and its first UNet output (same inputs) and
     latents must be within 1e-4 of one process's fp32 run normwise; in
     bf16 within twice the serving phase's mode both's distance from
     that fp32 run, its frames within mean 3 / p99 16 levels of the
     serving phase's; the trainers' losses (relative 2^-6), per-tensor
     gradient norms (2^-5 normwise) and tensors (2^-8 normwise) against
     one-process runs of the same configurations, the ranks' tensors and
     masks equal; each rank's launches exact by kernel and route, and the
     bytes its all-to-alls sent equal to the exchange computed from the
     shapes; then ``cli.infer --tp 2`` (the image path's settings, each
     rank on its heads and feed-forward columns): an fp32 twin of one
     CFG-pair UNet call (mode both, the cross-attention LoRA branches
     live) within 1e-4 of one process's normwise, the bf16 run's image
     and latents against the image path's (readings), K1 and K2
     launches a rank equal one process's by route, and the bytes of the
     model-axis reductions equal to those computed from the shapes
     (1,258,291,200 a bf16 UNet call). Its times are two ranks
     time-sharing one card;
   - the native clip preprocessing (before stage 2, whose in-memory
     clips go through it): a seeded (16, 1080, 1920, 3) BGR clip to
     1024^2 against the plain numpy version (the resize within one
     level, the output within 0.01), both timed, the cv2 chain beside;
   - LPIPS with seeded VGG16 weights read back from a safetensors file,
     card against CPU at one 256^2 pair, then ``cli.compare_outputs``'
     measures on the serving path's 16 mode-both frames against its
     content frames, timed; then ``cli.verify_parity --config_preset
     tiny`` on the synthetic checkpoint: a CPU run's images are the
     reference outputs of a card run through all four stages, which must
     exit 0.
   On each path K1's launches are also counted by route: every bf16 UNet
   attention on the wgmma route's d <= 256 kernel, every bf16 VAE
   attention on its wide kernel, every fp32 VAE attention on the FMA
   one; K4's: every backward of the trainer on the wgmma route, every
   VAE gradient on a sliced route, each with one delta launch; and K2's:
   every bf16 feed-forward on its wgmma
   route, every fp32 one on its 3xTF32 route.
5. Prints a JSON line of the stage-2 precision, 8-bit AdamW, stage-1,
   multi-process, native preprocessing, LPIPS, runbook, bf16 decode and
   VAE gradient readings, then one JSON line with every kernel's numbers
   (K1 as its five kernels, the FMA route's d = 448 instance standing for
   the JAX package's unpacked kernel, K4 as its four routes, K4's delta as a
   kernel of its own, K2 as its two routes, with the wgmma kernels', the
   FMA kernels', the 3xTF32 kernels', K4's and K2's and K3's registers,
   spills and wgmma serialisation from nvcc's report; the FMA, 3xTF32,
   K3, K4, K2 and K1 wgmma kernels must not spill, and K1's, K2's and
   K4's sliced bf16 wgmma kernels must not have their products
   serialised; the
   stage-2 precision check's launches count as a path of their own,
   "stage2_fp32", and stage 1's as "stage1"), then the last line
   {"ok": true, "device": {...}}. Any failure exits non-zero before
   that. Each K1 and K2 bf16 phase and each K3 phase also prints its
   share of the bound and its time against SDPA's or the three calls'.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores (the fp32 kernels run with TF32 off), HBM bandwidth; and
# TF32 in the tensor cores, which the 3xTF32 route (K1 and K4 in fp32 at
# d = 64) takes three times a product
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
PEAK_TF32 = 494.7e12

# tolerances against the plain version, |kernel - plain| <= atol +
# rtol*|plain|, inputs of unit variance. bf16: 2e-2 absolute plus 2^-6
# relative — the kernels round once, at the output, while the plain
# versions round to bf16 at up to four points (GEGLU: h, g, gelu(g) and
# the product), each worth half a bf16 ulp, 2^-8 relative, so the two
# may differ by ~4 half-ulps at the largest outputs (|GEGLU| reaches
# ~10 here). fp32: 1e-5 absolute, tightened from 1e-4 — only the order
# of the f32 sums differs, and the card shows at most ~2e-6 at these
# shapes (sums over up to 4096 keys or 1280 channels).
TOL = {"bfloat16": (2e-2, 2 ** -6), "float32": (1e-5, 0.0)}
# K1's bf16 `out` is ~1/sqrt(S) in size, mostly below TOL's absolute
# 2e-2, so it is also held to its own scale, normwise: |out - plain| /
# |plain| <= 2^-8. The kernel rounds P to bf16 (~1e-3 relative) and both
# round `out` once, ~1.5e-3 expected; a 0.97 copy or 2^-5 rms noise of
# `out` alone reads 3e-2. K2's bf16 output is held to the same limit: the
# kernel rounds once, the plain version at four points (h, g, gelu(g),
# the product), each ~1.7e-3 rms relative, so the two differ by close to
# the limit (an H100 reads 3.86e-3 at every K2 shape); a faulty copy
# reads 3e-2.
FWD_OUT_BF16 = 2 ** -8
# backward kernels (K4, K5), each output (dq, dk, dv) on its own:
# - bf16 against the output's own scale. K4's gradients are ~1/sqrt(S) in
#   size (rms ~0.04, largest ~0.3 at S = 1024-4096), so an absolute 2e-2
#   would pass a kernel wrong by the gradients' own size. Kernel and plain
#   version round p and ds (K4) at the same points, so only rounding
#   flips differ: on an H100, at most 2.4e-4 normwise and 5.3e-3 of the
#   largest entry (one bf16 ulp of an entry near the largest is up to
#   2^-7 of it). Limits: |kernel - plain|_2 <= 2^-10 |plain|_2, and the
#   largest error <= 2^-6 max|plain| (two such ulps).
# - fp32 1e-5 absolute plus 1e-5 relative: dk and dv are sums over up to
#   4096 query rows (K4) whose f32 order differs, and K4 recomputes p with
#   exp2 where the plain version takes exp.
# Each backward phase also holds two faulty copies of the kernel's
# outputs to the same check, and fails unless both are refused: the
# outputs scaled by 0.97, and the outputs plus noise of 2^-5 of each
# output's rms.
BWD_BF16_LIMITS = (2 ** -10, 2 ** -6)
TOL_BWD_F32 = (1e-5, 1e-5)
# K4's delta = rowsum(dO * O): kernel and formula both sum 64 f32
# products, in another order: 1e-5 absolute plus 1e-5 relative
TOL_DELTA = (1e-5, 1e-5)
# the first stage-2 step in bf16 against fp32 on the same weights, batch
# and draws: only a gross fault fails (a non-finite value, losses more
# than 5 % apart, or trainable gradients normwise more than 0.25 apart:
# zeroed gradients read 1, negated ones 2); the readings are reported.
# The step loads the rank-64 artifact set the serving path reads. The
# trainer's seeded fallback LoRA (rank 4, both factors drawn with std
# 1/rank, as the reference does) makes every projection's delta several
# times its base weight; the softmaxes saturate and the step is chaotic
# (``cli.profile_step --precision`` on an H100: fp32 against itself with
# its noise nudged by 2^-20 reads its gradients about 1 apart), so a
# comparison there would measure the weights, not the precision.
PRECISION_LIMITS = (0.05, 0.25)
PRECISION_FRAMES = 2
# K7 (LayerNorm): kernel and plain version both keep f32 inside and
# round once, so in bf16 they differ by at most one output ulp where an
# f32 difference in the last bits crosses a rounding boundary: 2^-7
# relative, plus 1e-5 absolute for outputs near zero. fp32: 1e-5 (the
# order of two 1280-term sums and rsqrt's last bits). The phase must
# also refuse the two faulty copies of the backward phases.
TOL_LN = {"bfloat16": (1e-5, 2 ** -7), "float32": (1e-5, 0.0)}

IMAGE_STEPS = 3
LORA_RANK = 64

NUM_FRAMES, RESOLUTION, STEPS = 16, 1024, 2
# stage 2: one epoch over a 10-frame video's 3 clip starts of 8 frames (3
# steps), a checkpoint at step 2, then a run resumed from it to step 4
TRAIN_FRAMES, TRAIN_VIDEO_FRAMES, TRAIN_STEPS = 8, 10, 3
TRAIN_CKPT_EVERY, TRAIN_RESUME_TO = 2, 4
# the 8-bit AdamW phase: seeded gradients of this global norm, below the
# trainer's clip of 0.5, so that the clip passes them through unchanged
ADAM8_GRAD_NORM = 0.25
# stage 1: two seeded 1024^2 instance images and two class images (one
# prior branch) in memory, rank 64; run A takes 8 steps with the column
# separation at 2 sample times (phases below), a checkpoint every 4 and
# validation at step 8 (3 modes x 4 DPM-Solver++ steps); run B resumes
# from checkpoint-4; runs C (fp32) and E (8-bit AdamW, Prodigy) take 2
STAGE1_STEPS, STAGE1_CKPT, STAGE1_SAMPLE_TIMES = 8, 4, 2
STAGE1_VAL_STEPS, STAGE1_SHORT = 4, 2
STAGE1_PHASES = ["reset", "sampling", "select", "zeroout"] * 2
# the selection step whose gradients run D recomputes on both devices
STAGE1_SELECT_STEP = 2
# what a selection writes into a projection's LoRA state
STAGE1_SELECTION_KEYS = ("score_content", "score_style", "mask_content",
                         "mask_style")


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_mem = nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def tf32x3_bound(phase, flops, nbytes, library="SDPA"):
    """A 3xTF32 kernel's phase: its bound becomes the larger of its bytes
    over the HBM rate and its three TF32 products a product over the
    tensor cores' TF32 rate; the FMA bound check_phase computed is kept
    as ``fma_bound_ms`` (an exact fp32 kernel's bound, which the tensor
    cores can beat)."""
    phase["fma_bound_ms"] = phase["bound_ms"]
    t_ops, t_mem = 3 * flops / PEAK_TF32, nbytes / PEAK_BYTES
    phase["bound_ms"] = max(t_ops, t_mem) * 1e3
    phase["bound_by"] = "operations" if t_ops >= t_mem else "bytes"
    print(f"    bounds: 3xTF32 {phase['bound_ms']:.4f} ms ({phase['bound_by']}"
          f"), FMA {phase['fma_bound_ms']:.4f} ms; plain "
          f"{phase['plain_ms']:.4f} ms, {library} "
          f"{phase['library_ms']:.4f} ms", flush=True)


def bwd_check(outs, refs, dtype_name):
    """(passes, worst normwise error, worst largest-error share) of
    backward outputs against the plain ones (see BWD_BF16_LIMITS)."""
    nrm = mx = excess = 0.0
    for o, r in zip(outs, refs):
        d, r = o.double() - r.double(), r.double()
        nrm = max(nrm, d.norm().item() / r.norm().item())
        mx = max(mx, d.abs().max().item() / r.abs().max().item())
        excess = max(excess,
                     (d.abs() - TOL_BWD_F32[1] * r.abs()).max().item())
    if dtype_name == "bfloat16":
        ok = nrm <= BWD_BF16_LIMITS[0] and mx <= BWD_BF16_LIMITS[1]
    else:
        ok = excess <= TOL_BWD_F32[0]
    return ok, nrm, mx


def faulty_copies(outs, refs):
    """The two faults every backward check must refuse."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    scaled = [(o.float() * 0.97).to(o.dtype) for o in outs]
    noisy = [(o.float() + torch.randn(o.shape, device=o.device,
                                      generator=gen)
              * (2 ** -5 * r.float().square().mean().sqrt())).to(o.dtype)
             for o, r in zip(outs, refs)]
    return {"scale 0.97": scaled, "noise 2^-5 rms": noisy}


def linear_gelu_mul(x, w, bias):
    """GEGLU in three PyTorch calls (K2's library yardstick)."""
    import torch.nn.functional as F
    h, g = F.linear(x, w, bias).chunk(2, dim=-1)
    return h * F.gelu(g)


def check_phase(name, kernel, plain, library, flops, nbytes, dtype_name,
                iters, bwd=False, tol=None, own_scale=None,
                library_name=None, exact=None):
    """Compare kernel vs plain (bwd: each output against its own scale,
    with the faulty-copy controls; tol: an (atol, rtol) of its own, also
    with the controls, each fault on all outputs and on each alone;
    own_scale: the first output's normwise error is also held to this;
    exact: the plain version on float64 copies of the inputs, which the
    kernel is then held to instead, the fp32 plain version's own distance
    reported beside), time all three; returns the phase dict."""
    import torch
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    extra = {}
    if exact is not None:
        ref64 = exact()
        refs64 = ref64 if isinstance(ref64, tuple) else (ref64,)
        extra["err_vs_fp32_plain"] = max(
            (o.float() - r.float()).abs().max().item()
            for o, r in zip(outs, refs))
        extra["fp32_plain_vs_exact"] = max(
            (r.double() - r64).abs().max().item()
            for r, r64 in zip(refs, refs64))
        print(f"    against the plain version in fp32: kernel "
              f"{extra['err_vs_fp32_plain']:.3e} apart; the fp32 plain "
              f"version {extra['fp32_plain_vs_exact']:.3e} from its "
              f"float64 evaluation", flush=True)
        refs = refs64
        del ref, ref64, refs64
        ref = None
    # differences in float64 where the reference is (not rounded to fp32
    # first), else in fp32
    prec = torch.float32 if exact is None else torch.float64
    err = max((o.to(prec) - r.to(prec)).abs().max().item()
              for o, r in zip(outs, refs))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    if bwd:
        ok, nrm, mx = bwd_check(outs, refs, dtype_name)
        controls = {c: bwd_check(f, refs, dtype_name)
                    for c, f in faulty_copies(outs, refs).items()}
        limit = (f"limit normwise {BWD_BF16_LIMITS[0]:g}, largest "
                 f"{BWD_BF16_LIMITS[1]:g} of max|plain|"
                 if dtype_name == "bfloat16" else
                 f"limit {TOL_BWD_F32[0]:g} + {TOL_BWD_F32[1]:g}*|plain|")
        reading = (f"normwise {nrm:.3e}, largest {mx:.3e} of max|plain|, "
                   f"{limit}; controls " + ", ".join(
                       f"{c}: {'passed' if c_ok else 'refused'} "
                       f"(normwise {c_nrm:.3e})"
                       for c, (c_ok, c_nrm, _) in controls.items()))
        extra.update(normwise_err=nrm, largest_err_share=mx,
                     controls={c: {"refused": not v[0],
                                   "normwise_err": v[1]}
                               for c, v in controls.items()})
        del controls
    else:
        atol, rtol = tol or TOL[dtype_name]

        def excess_of(cand):
            return max(((o.to(prec) - r.to(prec)).abs()
                        - rtol * r.to(prec).abs()).max().item()
                       for o, r in zip(cand, refs))

        def own_of(cand):  # the first output's normwise error
            return ((cand[0].to(prec) - refs[0].to(prec)).norm().item()
                    / refs[0].to(prec).norm().item())

        def refused(cand):
            return excess_of(cand) > atol or (own_scale is not None
                                              and own_of(cand) > own_scale)
        excess = excess_of(outs)
        ok = not refused(outs)
        reading = (f"limit {atol:g} + {rtol:g}*|plain|, excess "
                   f"{excess:.3e}")
        extra.update(atol=atol, rtol=rtol)
        if own_scale is not None:
            reading += (f"; first output normwise {own_of(outs):.3e}, "
                        f"limit {own_scale:g}")
            extra["own_scale"] = own_scale
        if tol is not None:
            # each fault applied to all outputs and to each one alone
            controls = {}
            for c, f in faulty_copies(outs, refs).items():
                controls[c] = {"refused": refused(f)}
                for i in range(len(outs) if len(outs) > 1 else 0):
                    alone = [*outs[:i], f[i], *outs[i + 1:]]
                    controls[f"{c}, output {i} alone"] = {
                        "refused": refused(alone)}
            extra["controls"] = controls
            reading += "; controls " + ", ".join(
                f"{c}: {'refused' if v['refused'] else 'passed'}"
                for c, v in controls.items())
    del out, ref, outs, refs
    ms = time_ms(kernel, iters)
    plain_ms = time_ms(plain, max(1, iters // 4))
    library_ms = None if library is None else time_ms(library,
                                                      max(1, iters // 4))
    bound_ms, bound_by = bound(flops, nbytes, dtype_name)
    print(f"  {name}: max_abs_err {err:.3e} ({reading}) kernel {ms:.4f} ms"
          f" plain {plain_ms:.4f} ms library "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    if not finite:
        fail(f"{name}: kernel output is not finite")
    if not ok:
        fail(f"{name}: error beyond the limit ({reading})")
    if not all(c["refused"] for c in extra.get("controls", {}).values()):
        fail(f"{name}: the check passed a faulty copy ({reading})")
    torch.cuda.empty_cache()
    return {"phase": name, "dtype": dtype_name, "max_abs_err": err,
            **extra, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            **({"library": library_name} if library_name else {}),
            "bound_ms": bound_ms, "bound_by": bound_by}


def vs_bound_and_library(phase, library="SDPA"):
    """Adds and prints a phase's share of its bound and its time over the
    library call's."""
    phase["bound_share"] = phase["bound_ms"] / phase["ms"]
    phase["vs_library"] = phase["ms"] / phase["library_ms"]
    print(f"    {100 * phase['bound_share']:.1f} % of bound, "
          f"{phase['vs_library']:.3f}x {library}'s time", flush=True)


def kernel_phases():
    import torch
    import torch.nn.functional as F
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(*shape, dtype, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen,
                           dtype=torch.float32).mul_(scale).to(dtype)

    phases = {"flash_attention_fwd": [], "geglu_projection": [],
              "temporal_attention": []}

    def flash_plain_chunked(q, k, v):
        b, sq, h, d = q.shape
        per = max(1, int(3e9 // (h * sq * k.shape[1] * 4)))
        parts = [fa.flash_attention_plain(q[i:i + per], k[i:i + per],
                                          v[i:i + per], d ** -0.5)
                 for i in range(0, b, per)]
        return (torch.cat([o for o, _ in parts]),
                torch.cat([lse for _, lse in parts]))

    # K1 (out and lse, under TOL, each phase also refusing the two faulty
    # copies): the bf16 UNet self-attention shapes of the paths (serving
    # levels 2 and 1 at 32 rows, the image path's level 2 at 2 rows, the
    # train step's level 1 at 8 rows), a ragged length (48 x 84 latents),
    # d = 128 and d = 256 (the wgmma route's other instances), the VAE
    # mid-block in fp32 (d=512, the FMA route) and in bf16 (the wide
    # wgmma kernel, --vae_dtype bfloat16) at 512^2 (S=4096, kv split in
    # two) and at the 1024^2 paths' S=16384, the 3xTF32 route (fp32 d =
    # 64: every UNet self-attention under --mixed_precision no) at the
    # serving path's levels 2 and 1, and the FMA route's other head dims
    # (fp32 d from 128 to 448, on no path; d = 448 is one of the JAX
    # package's unpacked kernel's), and stage 1's batch-1 levels 1 and 2
    # in bf16 and fp32. The plain version runs in batch chunks of at most
    # ~3 GB of logits (1 GiB at S=16384).
    phases["flash_attention_fwd_tf32x3"] = []
    phases["flash_attention_fwd_fma"] = []
    phases["flash_attention_fwd_wide"] = []
    phases["flash_attention_fwd_fma_d448"] = []
    for tag, (b, s, h, d), dt, iters in (
            ("unet_l2 (32,1024,20x64)", (32, 1024, 20, 64),
             torch.bfloat16, 20),
            ("unet_l1 (32,4096,10x64)", (32, 4096, 10, 64),
             torch.bfloat16, 5),
            ("image_l2 (2,1024,20x64)", (2, 1024, 20, 64),
             torch.bfloat16, 50),
            ("train_l1 (8,4096,10x64)", (8, 4096, 10, 64),
             torch.bfloat16, 10),
            ("ragged (2,4032,10x64)", (2, 4032, 10, 64), torch.bfloat16,
             20),
            ("d128 (2,4096,10x128)", (2, 4096, 10, 128), torch.bfloat16,
             20),
            ("d256 (2,4096,5x256)", (2, 4096, 5, 256), torch.bfloat16, 20),
            ("vae_mid (1,4096,1x512)", (1, 4096, 1, 512), torch.float32,
             5),
            ("vae_mid (1,16384,1x512)", (1, 16384, 1, 512), torch.float32,
             3),
            ("vae_mid (1,16384,1x512)", (1, 16384, 1, 512), torch.bfloat16,
             20),
            ("vae_mid (1,4096,1x512)", (1, 4096, 1, 512), torch.bfloat16,
             50),
            ("unet_l2 (32,1024,20x64)", (32, 1024, 20, 64), torch.float32,
             5),
            ("unet_l1 (32,4096,10x64)", (32, 4096, 10, 64), torch.float32,
             2),
            ("d128 (2,4096,10x128)", (2, 4096, 10, 128), torch.float32, 3),
            ("d192 (2,4096,2x192)", (2, 4096, 2, 192), torch.float32, 5),
            ("d256 (2,4096,5x256)", (2, 4096, 5, 256), torch.float32, 3),
            ("d320 (1,4096,1x320)", (1, 4096, 1, 320), torch.float32, 5),
            ("d384 (1,4096,1x384)", (1, 4096, 1, 384), torch.float32, 5),
            ("d448 (1,4096,1x448)", (1, 4096, 1, 448), torch.float32, 5),
            ("stage1_l1 (1,4096,10x64)", (1, 4096, 10, 64), torch.bfloat16,
             50),
            ("stage1_l2 (1,1024,20x64)", (1, 1024, 20, 64), torch.bfloat16,
             200),
            ("stage1_l1 (1,4096,10x64)", (1, 4096, 10, 64), torch.float32,
             10),
            ("stage1_l2 (1,1024,20x64)", (1, 1024, 20, 64), torch.float32,
             50),
            # a rank's share of the serving path under --frame_parallel 2
            ("fp2_unet_l1 (16,4096,10x64)", (16, 4096, 10, 64),
             torch.bfloat16, 10),
            ("fp2_unet_l2 (16,1024,20x64)", (16, 1024, 20, 64),
             torch.bfloat16, 20),
            # a rank's heads of the image path under --tp 2
            ("tp2_image_l1 (2,4096,5x64)", (2, 4096, 5, 64),
             torch.bfloat16, 50),
            ("tp2_image_l2 (2,1024,10x64)", (2, 1024, 10, 64),
             torch.bfloat16, 100)):
        qkv = randn(b, s, 3 * h * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        es = qkv.element_size()
        route = fa.route(dt, d)
        phase = check_phase(
            f"K1 {tag} {str(dt)[6:]} ({route})",
            lambda: fa.flash_attention_fwd(q, k, v),
            lambda: flash_plain_chunked(q, k, v),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            flops=4 * b * h * s * s * d,
            nbytes=4 * b * s * h * d * es + b * h * s * 4,
            dtype_name=str(dt)[6:], iters=iters, tol=TOL[str(dt)[6:]],
            own_scale=FWD_OUT_BF16 if dt == torch.bfloat16 else None)
        phase["kernel_route"] = route
        if route == "tf32x3":
            tf32x3_bound(phase, 4 * b * h * s * s * d,
                         4 * b * s * h * d * es + b * h * s * 4)
        vs_bound_and_library(phase)
        kernel = ("_wide" if route == "wgmma" and d in fa.WIDE_HEAD_DIMS
                  else "" if route == "wgmma" else f"_{route}")
        if route == "fma" and d == 448:
            kernel = "_fma_d448"  # the kernels line's entry for `:50`
        phases["flash_attention_fwd" + kernel].append(phase)
        del qkv, q, k, v, qt, kt, vt

    # K6: the JAX package's unpacked (B*H, S, D) kernel serves head dims
    # the TPU cannot pack (d = 192); the port's K1 reads any (B, S, H, D)
    # view, so its d=192 instance stands for it
    b, s_, h, d = 2, 4096, 2, 192
    qkv = randn(b, s_, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    route = fa.route(torch.bfloat16, d)
    phases["flash_attention_fwd_d192"] = [check_phase(
        f"K6 (K1 d=192) (2,4096,2x192) bfloat16 ({route})",
        lambda: fa.flash_attention_fwd(q, k, v),
        lambda: fa.flash_attention_plain(q, k, v, d ** -0.5),
        lambda: F.scaled_dot_product_attention(qt, kt, vt),
        flops=4 * b * h * s_ * s_ * d,
        nbytes=4 * b * s_ * h * d * 2 + b * h * s_ * 4,
        dtype_name="bfloat16", iters=10, tol=TOL["bfloat16"],
        own_scale=FWD_OUT_BF16)]
    phases["flash_attention_fwd_d192"][0]["kernel_route"] = route
    vs_bound_and_library(phases["flash_attention_fwd_d192"][0])
    del qkv, q, k, v, qt, kt, vt

    # K2 (under TOL; bf16 also normwise under FWD_OUT_BF16, each phase
    # refusing the two faulty copies): the FF shapes of the paths, spatial
    # and motion level 2 and level 1 at the serving path's 32 rows, motion
    # level 0, spatial level 2 at the image path's 2 rows, levels 2 and 1
    # at stage 1's one row (1024 and 4096 tokens), and the first three and
    # stage 1's two in fp32 (the 3xTF32 route: every feed-forward under
    # --mixed_precision no). The yardstick is three PyTorch calls:
    # F.linear over the fused weight and bias, the exact-erf gate, the
    # product; F.linear alone is also timed, a reading of cuBLAS's rate
    # for the same products. fp32 is held to TOL against the plain version
    # on float64 copies of the inputs (`exact`): the plain version in fp32
    # (cuBLAS's fp32 GEMM) is itself ~3e-5 from it at these shapes (sums
    # over 320-1280 channels of outputs up to ~11), while an exact-fp32
    # kernel that summed in cuBLAS's order would agree with it more
    # closely than either with the exact value; its distance from the
    # fp32 plain version is reported beside.
    phases["geglu_projection_tf32x3"] = []
    for tag, shape, dt, iters in (
            ("spatial_l2 (32768,1280->5120)", (32768, 1280),
             torch.bfloat16, 10),
            ("l1 (131072,640->2560)", (131072, 640), torch.bfloat16, 5),
            ("motion_l0 (524288,320->1280)", (524288, 320),
             torch.bfloat16, 5),
            ("image_l2 (2048,1280->5120)", (2048, 1280), torch.bfloat16,
             50),
            ("stage1_l2 (1024,1280->5120)", (1024, 1280), torch.bfloat16,
             50),
            ("stage1_l1 (4096,640->2560)", (4096, 640), torch.bfloat16, 50),
            ("spatial_l2 (32768,1280->5120)", (32768, 1280),
             torch.float32, 3),
            ("l1 (131072,640->2560)", (131072, 640), torch.float32, 3),
            ("motion_l0 (524288,320->1280)", (524288, 320),
             torch.float32, 3),
            ("stage1_l2 (1024,1280->5120)", (1024, 1280), torch.float32,
             20),
            ("stage1_l1 (4096,640->2560)", (4096, 640), torch.float32, 20),
            # a rank's share of the serving path under --frame_parallel 2
            ("fp2_spatial_l2 (16384,1280->5120)", (16384, 1280),
             torch.bfloat16, 20),
            ("fp2_l1 (65536,640->2560)", (65536, 640), torch.bfloat16, 10),
            ("fp2_motion_l0 (262144,320->1280)", (262144, 320),
             torch.bfloat16, 10),
            # a rank's feed-forward columns of the image path under --tp 2
            ("tp2_image_l1 (8192,640->1280)", (8192, 640, 1280),
             torch.bfloat16, 50),
            ("tp2_image_l2 (2048,1280->2560)", (2048, 1280, 2560),
             torch.bfloat16, 50)):
        m, c, *rest = shape
        inner = rest[0] if rest else 4 * c
        x = randn(m, c, dtype=dt)
        w = randn(2 * inner, c, dtype=dt, scale=c ** -0.5)
        bias = randn(2 * inner, dtype=dt, scale=0.1)
        gate = geglu._default_gate_for(dt)
        es = x.element_size()
        route = geglu.route(dt)
        flops = 4 * m * c * inner
        nbytes = (m * c + 2 * inner * c + 2 * inner + m * inner) * es
        phase = check_phase(
            f"K2 {tag} {str(dt)[6:]} gate {gate} ({route})",
            lambda: geglu.geglu_fwd(x, w, bias, gate),
            lambda: geglu.geglu_plain(x, w, bias, gate),
            lambda: linear_gelu_mul(x, w, bias),
            flops=flops, nbytes=nbytes,
            dtype_name=str(dt)[6:], iters=iters, tol=TOL[str(dt)[6:]],
            own_scale=FWD_OUT_BF16 if dt == torch.bfloat16 else None,
            library_name="F.linear + F.gelu + mul (three calls)",
            exact=None if dt == torch.bfloat16 else lambda: geglu.geglu_plain(
                x.double(), w.double(), bias.double(), gate))
        phase["kernel_route"] = route
        if route == "tf32x3":
            tf32x3_bound(phase, flops, nbytes, "the three calls")
        vs_bound_and_library(phase, "the three calls")
        phase["linear_ms"] = time_ms(lambda: F.linear(x, w, bias), iters)
        print(f"    F.linear alone {phase['linear_ms']:.4f} ms", flush=True)
        phases["geglu_projection" + ("_tf32x3" if route == "tf32x3"
                                     else "")].append(phase)
        del x, w, bias

    # K3 (tensor-core forward: mma.sync, fp32 at 3xTF32; under TOL, bf16
    # also normwise under FWD_OUT_BF16, each phase refusing the two faulty
    # copies): the serving path's motion levels 0-2 (F=16, N=32768, 4096,
    # 1024, 8 heads x d = 40, 80, 160) in bf16 and in fp32 (--mixed_precision
    # no), stage 2's three levels at 8 frames, and level 2 at 32 frames
    # (--num_frames 32) in both dtypes
    for tag, (f, n, h, d), dt, iters in (
            ("serving_l0", (16, 32768, 8, 40), torch.bfloat16, 20),
            ("serving_l0", (16, 32768, 8, 40), torch.float32, 10),
            ("serving_l1", (16, 4096, 8, 80), torch.bfloat16, 20),
            ("serving_l1", (16, 4096, 8, 80), torch.float32, 20),
            ("serving_l2", (16, 1024, 8, 160), torch.bfloat16, 20),
            ("serving_l2", (16, 1024, 8, 160), torch.float32, 20),
            ("stage2_l0", (8, 16384, 8, 40), torch.bfloat16, 20),
            ("stage2_l1", (8, 4096, 8, 80), torch.bfloat16, 20),
            ("stage2_l2", (8, 1024, 8, 160), torch.bfloat16, 20),
            ("clip32_l2", (32, 1024, 8, 160), torch.bfloat16, 20),
            ("clip32_l2", (32, 1024, 8, 160), torch.float32, 10),
            # the one-process serving path's levels 1 and 2 hold 2 x 4096
            # and 2 x 1024 pixels: the serving_l1 and serving_l2 rows above
            # have half those, a rank's share under --frame_parallel 2,
            # whose level 0 is fp2_l0
            ("serving_l1_2x4096", (16, 8192, 8, 80), torch.bfloat16, 20),
            ("serving_l2_2x1024", (16, 2048, 8, 160), torch.bfloat16, 20),
            ("fp2_l0", (16, 16384, 8, 40), torch.bfloat16, 20),
            # a rank's pixel shard of the two-process stage-2 run (512^2)
            ("fp2_512_l0", (8, 2048, 8, 40), torch.bfloat16, 20),
            ("fp2_512_l1", (8, 512, 8, 80), torch.bfloat16, 20),
            ("fp2_512_l2", (8, 128, 8, 160), torch.bfloat16, 20)):
        qkv = randn(f, n, 3 * h * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
        qt, kt, vt = (t.permute(1, 2, 0, 3) for t in (q, k, v))  # (N,H,F,d)
        es = qkv.element_size()
        phase = check_phase(
            f"K3 {tag} ({f},{n},{h}x{d}) {str(dt)[6:]}",
            lambda: ta.temporal_attention_fwd(q, k, v),
            lambda: ta.temporal_attention_plain(q, k, v, d ** -0.5),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            flops=4 * f * f * n * h * d,
            nbytes=4 * f * n * h * d * es,
            dtype_name=str(dt)[6:], iters=iters, tol=TOL[str(dt)[6:]],
            own_scale=FWD_OUT_BF16 if dt == torch.bfloat16 else None)
        vs_bound_and_library(phase)
        phases["temporal_attention"].append(phase)
        del qkv, q, k, v, qt, kt, vt
    return phases


def bwd_phases():
    """K4 and K5 against their plain versions at the stage-2 path's
    shapes (B*F = 8 rows at 1024^2). The library yardstick is
    scaled_dot_product_attention's backward (forward taken once through
    autograd, the backward timed alone)."""
    import torch
    import torch.nn.functional as F
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen,
                           dtype=torch.float32).to(dtype)

    def sdpa_bwd(q, k, v, do, perm):
        qt, kt, vt = (t.permute(*perm).contiguous().requires_grad_()
                      for t in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt)
        go = do.unflatten(-1, (q.shape[2], q.shape[3])).permute(*perm)
        return lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                           retain_graph=True)

    phases = {"flash_attention_bwd": [], "flash_attention_bwd_tf32x3": [],
              "flash_attention_bwd_sliced": [],
              "flash_attention_bwd_sliced_tf32x3": [],
              "flash_attention_bwd_delta": [], "temporal_attention_bwd": []}
    # K4: spatial self-attention at level 1 (S = 4096, 10 heads) and
    # level 2 (S = 1024, 20 heads), d = 64, and a ragged length that
    # leaves q and kv tails in both kernels, in bf16 (the wgmma route) and
    # fp32 (the 3xTF32 route), and both levels at stage 1's batch of one;
    # flops are the JAX cost estimate
    # 10*B*H*Sq*Sk*D (the bound); the two-kernel design does 14
    # (design_bound_ms); bytes q, k, v, o, dO in and dq, dk, dv out plus
    # lse. The kernel time includes the delta kernel, SDPA's backward
    # computes its own.
    for tag, (b, s, h, d), dt, iters in (
            ("unet_l1 (8,4096,10x64)", (8, 4096, 10, 64), torch.bfloat16, 5),
            ("unet_l2 (8,1024,20x64)", (8, 1024, 20, 64), torch.bfloat16,
             20),
            ("ragged (2,1100,2x64)", (2, 1100, 2, 64), torch.bfloat16, 50),
            ("unet_l2 (8,1024,20x64)", (8, 1024, 20, 64), torch.float32, 5),
            ("unet_l1 (8,4096,10x64)", (8, 4096, 10, 64), torch.float32, 2),
            ("ragged (2,1100,2x64)", (2, 1100, 2, 64), torch.float32, 50),
            ("stage1_l1 (1,4096,10x64)", (1, 4096, 10, 64), torch.bfloat16,
             20),
            ("stage1_l2 (1,1024,20x64)", (1, 1024, 20, 64), torch.bfloat16,
             100),
            ("stage1_l1 (1,4096,10x64)", (1, 4096, 10, 64), torch.float32,
             5),
            ("stage1_l2 (1,1024,20x64)", (1, 1024, 20, 64), torch.float32,
             20)):
        qkv = randn(b, s, 3 * h * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
        out, lse = fa.flash_attention_fwd(q, k, v)
        do = randn(b, s, h * d, dtype=dt)
        es = qkv.element_size()
        route = fa.bwd_route(dt, d)
        phase = check_phase(
            f"K4 {tag} {str(dt)[6:]} ({route})",
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do),
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                 d ** -0.5),
            sdpa_bwd(q, k, v, do, (0, 2, 1, 3)),
            flops=10 * b * h * s * s * d,
            nbytes=8 * b * s * h * d * es + b * h * s * 4,
            dtype_name=str(dt)[6:], iters=iters, bwd=True)
        phase["kernel_route"] = route
        nbytes = 8 * b * s * h * d * es + b * h * s * 4
        phase["design_bound_ms"] = bound(14 * b * h * s * s * d, nbytes,
                                         str(dt)[6:])[0]
        if route == "tf32x3":
            tf32x3_bound(phase, 10 * b * h * s * s * d, nbytes)
            phase["fma_design_bound_ms"] = phase["design_bound_ms"]
            phase["design_bound_ms"] = max(
                3 * 14 * b * h * s * s * d / PEAK_TF32,
                nbytes / PEAK_BYTES) * 1e3
        print(f"    design bound (14 flops): {phase['design_bound_ms']:.4f} "
              f"ms, {phase['design_bound_ms'] / phase['ms']:.0%} of it "
              f"reached; SDPA's backward {phase['library_ms']:.4f} ms "
              f"({phase['ms'] / phase['library_ms']:.3f}x its time)",
              flush=True)
        phases["flash_attention_bwd" + ("_tf32x3" if route == "tf32x3"
                                        else "")].append(phase)
        # K4's delta = rowsum(dO * O) at the same shape; bound by its
        # bytes (O and dO in, delta out); torch.linalg.vecdot over the
        # (B, Sq, H, D) views is one PyTorch call of the same function
        # (its (B, Sq, H) result in the input dtype)
        o4, do4 = (t.unflatten(-1, (h, d)) for t in (out, do))
        phases["flash_attention_bwd_delta"].append(check_phase(
            f"K4 delta {tag} {str(dt)[6:]}",
            lambda: fa.flash_attention_bwd_delta(out, do, h),
            lambda: fa.flash_attention_bwd_delta_plain(out, do, h),
            lambda: torch.linalg.vecdot(do4, o4, dim=-1),
            flops=2 * b * s * h * d,
            nbytes=2 * b * s * h * d * es + b * h * s * 4,
            dtype_name=str(dt)[6:], iters=iters * 10, tol=TOL_DELTA,
            library_name="torch.linalg.vecdot"))
        del o4, do4
        del qkv, q, k, v, out, lse, do
        torch.cuda.empty_cache()
    sliced_phases(phases, randn, sdpa_bwd)
    # K5 (tensor-core backward: mma.sync, fp32 at 3xTF32): motion level 0
    # (F = 8, N = 16384, 8 heads x d = 40) in bf16 and fp32, levels 1 and
    # 2 in bf16, level 0 at the stage2_fp32 path's 2 frames in fp32, and
    # 32 frames at the widest heads K3 takes (pair_fits: fp32 d = 600,
    # bf16 d = 1208; K5 takes them in column chunks); flops 11*F*F*N*P and
    # bytes 7*F*N*P*itemsize are the JAX cost estimates
    for tag, (f, n, h, d), dt, iters in (
            ("motion_l0 (8,16384,8x40)", (8, 16384, 8, 40), torch.bfloat16,
             20),
            ("motion_l0 (8,16384,8x40)", (8, 16384, 8, 40), torch.float32,
             10),
            ("motion_l1 (8,4096,8x80)", (8, 4096, 8, 80), torch.bfloat16, 20),
            ("motion_l2 (8,1024,8x160)", (8, 1024, 8, 160), torch.bfloat16,
             20),
            ("stage2_fp32_l0 (2,16384,8x40)", (2, 16384, 8, 40),
             torch.float32, 20),
            ("clip32_widest (32,1024,2x600)", (32, 1024, 2, 600),
             torch.float32, 5),
            ("clip32_widest (32,1024,2x1208)", (32, 1024, 2, 1208),
             torch.bfloat16, 5),
            # a rank's pixel shard of stage 2 (1024^2, 8 frames) under
            # --frame_parallel 2
            ("fp2_motion_l0 (8,8192,8x40)", (8, 8192, 8, 40),
             torch.bfloat16, 20),
            ("fp2_motion_l1 (8,2048,8x80)", (8, 2048, 8, 80),
             torch.bfloat16, 20),
            ("fp2_motion_l2 (8,512,8x160)", (8, 512, 8, 160),
             torch.bfloat16, 20),
            # the two-process stage-2 run's shards (512^2)
            ("fp2_512_l0 (8,2048,8x40)", (8, 2048, 8, 40), torch.bfloat16,
             20),
            ("fp2_512_l1 (8,512,8x80)", (8, 512, 8, 80), torch.bfloat16, 20),
            ("fp2_512_l2 (8,128,8x160)", (8, 128, 8, 160), torch.bfloat16,
             20)):
        qkv = randn(f, n, 3 * h * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
        do = randn(f, n, h * d, dtype=dt)
        es = qkv.element_size()
        phase = check_phase(
            f"K5 {tag} {str(dt)[6:]}",
            lambda: ta.temporal_attention_bwd(q, k, v, do),
            lambda: ta.temporal_attention_bwd_plain(q, k, v, do, d ** -0.5),
            sdpa_bwd(q, k, v, do, (1, 2, 0, 3)),
            flops=11 * f * f * n * h * d, nbytes=7 * f * n * h * d * es,
            dtype_name=str(dt)[6:], iters=iters, bwd=True)
        phase["chunks"] = ta.bwd_plan(f, d, es, h, n)[2]
        vs_bound_and_library(phase, "SDPA's backward")
        phases["temporal_attention_bwd"].append(phase)
        del qkv, q, k, v, do
        torch.cuda.empty_cache()
    return phases


def sdpa_backend(q, k, v):
    """The backend scaled_dot_product_attention dispatches (q, k, v) to
    (PyTorch's own choice, torch._fused_sdp_choice), by name."""
    import torch
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v)).name
    except (ImportError, AttributeError, RuntimeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


# K4 at d = 128-512 (the sliced kernels): the VAE's mid-block attention
# (one head, d = 512) at the 1024^2 and 512^2 paths' token counts, then
# every other head dim K1 takes, each in bf16 and fp32 (tag, (B, S, H, D),
# iterations by dtype)
SLICED_SHAPES = (
    ("vae_1024 (1,16384,1x512)", (1, 16384, 1, 512), (5, 1)),
    ("vae_512 (1,4096,1x512)", (1, 4096, 1, 512), (20, 3)),
    ("d128 (2,4096,10x128)", (2, 4096, 10, 128), (5, 1)),
    ("d192 (2,4096,2x192)", (2, 4096, 2, 192), (10, 2)),
    ("d320 (1,4096,1x320)", (1, 4096, 1, 320), (20, 3)),
    ("d384 (1,4096,1x384)", (1, 4096, 1, 384), (20, 3)),
    ("d448 (1,4096,1x448)", (1, 4096, 1, 448), (20, 3)))


def sliced_phases(phases, randn, sdpa_bwd):
    """K4's sliced kernels against the plain backward at SLICED_SHAPES
    in bf16 (the "wgmma_sliced" route) and fp32 ("tf32x3_sliced"), with
    the backward phases' limits and faulty-copy controls; each also run
    twice and held bitwise equal (no atomics), and its delta kernel held
    to the formula. Bounds: the JAX cost estimate's 10 * B*H*Sq*Sk*D
    flops (`bound_ms`; fp32 at 3 TF32 products a product, the FMA bound
    beside) and the design's own count (`bwd_plan`'s flops:
    `design_bound_ms`); bytes q, k, v, o, dO in and dq, dk, dv out plus
    lse. The yardstick is SDPA's backward, its backend named."""
    import torch
    from video_style_transfer_tpu_torch.ops import flash_attention as fa

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        for tag, (b, s, h, d), iters in SLICED_SHAPES:
            qkv = randn(b, s, 3 * h * d, dtype=dt)
            q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
            out, lse = fa.flash_attention_fwd(q, k, v)
            do = randn(b, s, h * d, dtype=dt)
            es = qkv.element_size()
            plan = fa.bwd_plan(dt, d)
            route = plan["route"]
            def kernel():
                return fa.flash_attention_bwd(q, k, v, out, lse, do)
            first, again = kernel(), kernel()
            torch.cuda.synchronize()
            repeat = all(torch.equal(x, y) for x, y in zip(first, again))
            del first, again
            if not repeat:
                fail(f"K4 {tag} {name} ({route}): two backwards differ")
            library = sdpa_bwd(q, k, v, do, (0, 2, 1, 3))
            qt = q.permute(0, 2, 1, 3).contiguous().requires_grad_()
            backend = sdpa_backend(qt, qt, qt)
            del qt
            flops = 10 * b * h * s * s * d
            nbytes = 8 * b * s * h * d * es + b * h * s * 4
            phase = check_phase(
                f"K4 {tag} {name} ({route})", kernel,
                lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     d ** -0.5),
                library, flops=flops, nbytes=nbytes, dtype_name=name,
                iters=iters[dt == torch.float32], bwd=True,
                library_name=f"SDPA backward ({backend})")
            del library
            design = plan["flops"] * b * h * s * s * d
            phase.update(kernel_route=route, bitwise_repeatable=True,
                         sdpa_backend=backend, design_flops=plan["flops"],
                         slices=plan["slices"], cluster=plan["cluster"],
                         owners=plan.get("owners"), stream=plan["stream"],
                         stages=plan["stages"])
            if route == "tf32x3_sliced":
                tf32x3_bound(phase, flops, nbytes,
                             library=f"SDPA ({backend})")
                phase["design_bound_ms"] = max(
                    3 * design / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3
            else:
                phase["design_bound_ms"] = bound(design, nbytes, name)[0]
            vs_bound_and_library(phase, f"SDPA's backward ({backend})")
            print(f"    plan: D split across {plan['split']} (a cluster "
                  f"of {plan['cluster']} block(s)), {plan['rows']} own rows "
                  f"a block, streamed rows {plan['stream']}, stages "
                  f"{plan['stages']}; "
                  f"design bound ({plan['flops']} flops): "
                  f"{phase['design_bound_ms']:.4f} ms, "
                  f"{phase['design_bound_ms'] / phase['ms']:.1%} of it "
                  f"reached; bitwise repeatable", flush=True)
            phases["flash_attention_bwd_sliced"
                   + ("_tf32x3" if route == "tf32x3_sliced" else "")
                   ].append(phase)
            o4, do4 = (t.unflatten(-1, (h, d)) for t in (out, do))
            phases["flash_attention_bwd_delta"].append(check_phase(
                f"K4 delta {tag} {name}",
                lambda: fa.flash_attention_bwd_delta(out, do, h),
                lambda: fa.flash_attention_bwd_delta_plain(out, do, h),
                lambda: torch.linalg.vecdot(do4, o4, dim=-1),
                flops=2 * b * s * h * d,
                nbytes=2 * b * s * h * d * es + b * h * s * 4,
                dtype_name=name, iters=20, tol=TOL_DELTA,
                library_name="torch.linalg.vecdot"))
            del o4, do4, qkv, q, k, v, out, lse, do
            torch.cuda.empty_cache()


def layer_norm_phases():
    """K7 against its plain version and ``F.layer_norm`` at the LayerNorm
    shapes of a serving step (UNet levels 2 and 1, motion level 0, the
    CLIP bigG encoder with M not a multiple of 8), then forward and
    backward through its autograd Function against the plain formula.
    Returns (phases, launches made here)."""
    import torch
    import torch.nn.functional as F
    from video_style_transfer_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale + shift).to(dtype)

    before = ln.LAUNCHES
    phases = []
    for tag, (m, c), dt, iters in (
            ("unet_l2 (32*1024,1280)", (32 * 1024, 1280), torch.bfloat16, 50),
            ("unet_l1 (32*4096,640)", (32 * 4096, 640), torch.bfloat16, 50),
            ("motion_l0 (16*32768,320)", (16 * 32768, 320), torch.bfloat16,
             20),
            ("clip_g (2*77,1280)", (2 * 77, 1280), torch.bfloat16, 50),
            ("unet_l2 (32*1024,1280)", (32 * 1024, 1280), torch.float32,
             20)):
        x = randn(m, c, dtype=dt, scale=1.5, shift=0.3)
        w = randn(c, dtype=dt, scale=0.1, shift=1.0)
        b = randn(c, dtype=dt, scale=0.1)
        phases.append(check_phase(
            f"K7 {tag} {str(dt)[6:]}",
            lambda: ln.layer_norm_fwd(x, w, b),
            lambda: ln.layer_norm_reference(x, w, b),
            lambda: F.layer_norm(x, (c,), w, b, 1e-5),
            flops=8 * m * c, nbytes=2 * m * c * x.element_size(),
            dtype_name=str(dt)[6:], iters=iters,
            tol=TOL_LN[str(dt)[6:]]))
        del x, w, b

    # gradients: the Function's backward differentiates the plain formula
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        ins = [randn(4096, 640, dtype=dt), randn(640, dtype=dt, shift=1.0),
               randn(640, dtype=dt, scale=0.1)]
        cot = randn(4096, 640, dtype=dt)
        grads = []
        for fn in (ln.layer_norm, ln.layer_norm_reference):
            leaves = [t.clone().requires_grad_() for t in ins]
            out = fn(*leaves)
            if out.grad_fn is None:
                fail("K7: the output carries no grad_fn")
            grads.append(torch.autograd.grad(out, leaves, cot))
        for a, r in zip(*grads):
            worst = max(worst, (a.float() - r.float()).abs().max().item()
                        / r.float().abs().max().item())
    print(f"  K7 backward (4096,640) f32 and bf16 through the autograd "
          f"Function vs the plain formula: worst error {worst:.2e} of the "
          f"gradient's max (limit 1e-5: both differentiate the same "
          f"formula on the same inputs)", flush=True)
    if not worst <= 1e-5:
        fail("K7: backward through the autograd Function disagrees")
    try:
        ln.layer_norm_fwd(randn(8, 324, dtype=torch.bfloat16),
                          randn(324, dtype=torch.bfloat16),
                          randn(324, dtype=torch.bfloat16))
    except ValueError:
        pass
    else:
        fail("K7: an unsupported width on the card did not raise")
    return phases, ln.LAUNCHES - before


def small_reference():
    """The tiny 2-step video pipeline on the card (the GEGLU and
    temporal-attention kernels in fp32, where the tiny shapes take them)
    against the same pipeline on the CPU (the plain versions), from the
    same weights, prompts and noise, all drawn on the CPU."""
    import torch
    from video_style_transfer_tpu_torch.cli import common
    from video_style_transfer_tpu_torch.models.clip import init_clip
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.models.vae import init_vae_decoder
    from video_style_transfer_tpu_torch.ops import geglu
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta
    from video_style_transfer_tpu_torch.pipelines.video import generate_video
    from video_style_transfer_tpu_torch.utils.convert import to_device

    ucfg, vcfg, lcfg, gcfg = common.model_configs(smoke=True, motion=True)
    cpu = common.ModelBundle(
        unet=init_unet(Init(0), ucfg), unet_cfg=ucfg,
        vae=init_vae_decoder(Init(1), vcfg), vae_cfg=vcfg,
        clip_l=init_clip(Init(2), lcfg), clip_l_cfg=lcfg,
        clip_g=init_clip(Init(3), gcfg), clip_g_cfg=gcfg,
        device=torch.device("cpu"), vae_scale_factor=2)
    with torch.inference_mode():
        uncond = common.negative_conditioning(cpu, "blurry", height=16,
                                              width=16)
        cond = common.make_conditioning(cpu, "a horse in the snow",
                                        height=16, width=16)
        noise = torch.randn(4, 8, 8, 4, generator=torch.Generator()
                            .manual_seed(0))

        def run(dev):
            return generate_video(
                to_device(cpu.unet, dev), ucfg, to_device(cpu.vae, dev),
                vcfg, to_device(uncond, dev), to_device(cond, dev),
                num_frames=4, height=16, width=16, num_steps=2,
                dtype=torch.float32, decode_chunk=4, vae_scale_factor=2,
                device=dev, noise=noise, check_finite=True).cpu()

        before = (geglu.LAUNCHES, ta.LAUNCHES)
        gpu_frames = run(torch.device("cuda"))
        used = (geglu.LAUNCHES - before[0], ta.LAUNCHES - before[1])
        cpu_frames = run(torch.device("cpu"))
    diff = int((gpu_frames.int() - cpu_frames.int()).abs().max())
    print(f"small-input reference: tiny 2-step video (GEGLU / temporal "
          f"kernel launches on the card {used}), cuda vs cpu max frame "
          f"difference {diff} levels (limit 2)", flush=True)
    if diff > 2 or min(used) == 0:
        fail(f"tiny pipeline on cuda differs from cpu by {diff} levels "
             f"(kernel launches {used})")


def counters():
    from video_style_transfer_tpu_torch.cli.common import (
        kernel_launch_counts)
    return kernel_launch_counts()


def reset_counters():
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu, layer_norm
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta
    fa.LAUNCHES = fa.BWD_LAUNCHES = fa.DELTA_LAUNCHES = geglu.LAUNCHES = 0
    ta.LAUNCHES = ta.BWD_LAUNCHES = layer_norm.LAUNCHES = 0
    fa.ROUTE_LAUNCHES.update(wgmma=0, tf32x3=0, fma=0)
    fa.WIDE_LAUNCHES = 0
    fa.BWD_ROUTE_LAUNCHES.update(wgmma=0, tf32x3=0, wgmma_sliced=0,
                                 tf32x3_sliced=0)
    geglu.ROUTE_LAUNCHES.update(wgmma=0, tf32x3=0)


def check_routes(path, counts, wgmma, fma, bwd_wgmma=0, wide=0, tf32x3=0,
                 bwd_tf32x3=0, geglu_tf32x3=0, bwd_wgmma_sliced=0,
                 bwd_tf32x3_sliced=0):
    """K1's launches on a path split by route: every bf16 UNet attention
    (d = 64) took the wgmma route's d <= 256 kernel, every fp32 one the
    3xTF32 route, every bf16 VAE attention (d = 512) the wgmma route's
    wide kernel (`wide` of the route's launches), every fp32 VAE
    attention (d = 512) the FMA one; K4's: every bf16 UNet backward (d =
    64) the wgmma route, every fp32 one the 3xTF32 route, every bf16 VAE
    backward (d = 512) the wgmma_sliced route, every fp32 one the
    tf32x3_sliced route; and K2's: every fp32 feed-forward
    (`geglu_tf32x3`) the 3xTF32 route, every other one the bf16 wgmma
    route. Returns the path's counts with K1 split into its four kernels,
    K4 into its four routes and K2 into its two."""
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu
    k2 = counts["geglu_projection"]
    got = {"K1": dict(fa.ROUTE_LAUNCHES), "K1 wide": fa.WIDE_LAUNCHES,
           "K4": dict(fa.BWD_ROUTE_LAUNCHES),
           "K2": dict(geglu.ROUTE_LAUNCHES)}
    want = {"K1": {"wgmma": wgmma + wide, "tf32x3": tf32x3, "fma": fma},
            "K1 wide": wide,
            "K4": {"wgmma": bwd_wgmma, "tf32x3": bwd_tf32x3,
                   "wgmma_sliced": bwd_wgmma_sliced,
                   "tf32x3_sliced": bwd_tf32x3_sliced},
            "K2": {"wgmma": k2 - geglu_tf32x3, "tf32x3": geglu_tf32x3}}
    print(f"K1, K4 and K2 launches on the {path} path by route: {got} "
          f"(expected {want})", flush=True)
    if got != want:
        fail(f"K1/K4/K2 routes on the {path} path: {got}, expected {want}")
    return {**counts, "flash_attention_fwd": wgmma,
            "flash_attention_fwd_wide": wide,
            "flash_attention_fwd_tf32x3": tf32x3,
            "flash_attention_fwd_fma": fma,
            "flash_attention_bwd": bwd_wgmma,
            "flash_attention_bwd_tf32x3": bwd_tf32x3,
            "flash_attention_bwd_sliced": bwd_wgmma_sliced,
            "flash_attention_bwd_sliced_tf32x3": bwd_tf32x3_sliced,
            "flash_attention_bwd_by_route": got["K4"],
            "geglu_projection": k2 - geglu_tf32x3,
            "geglu_projection_tf32x3": geglu_tf32x3}


def write_lora_artifacts(out_dir, unet_cfg, *, rank, seed, device,
                         up_scale=1.0):
    """A stage-1 artifact set of seeded factors in the reference's file
    layout, for a UNet of `unet_cfg`, without building its weights (the
    LoRA shapes come from a shape-only tree). `up_scale` shrinks the up
    factors. Returns the number of projections written."""
    from video_style_transfer_tpu_torch.lora.surgery import (
        insert_unziplora, iter_spatial_attention_paths, tree_get)
    from video_style_transfer_tpu_torch.models.layers import Init, MetaInit
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.utils.checkpoint import (
        export_stage1_artifacts)

    params, state = insert_unziplora(init_unet(MetaInit(), unet_cfg),
                                     Init(seed, device), rank=rank)
    n = 0
    for path in iter_spatial_attention_paths(params):
        for proj in tree_get(params, path).values():
            for branch in ("content", "style"):
                proj["lora"][branch]["up"] *= up_scale
            n += 1
    export_stage1_artifacts(out_dir, "unziplora", params, state)
    return n


def small_cli_reference(tmp):
    """The image and video CLIs on the card against the same on the CPU
    (the plain versions), f32, from files: a synthetic tiny checkpoint
    directory with byte-level tokenizers, a rank-4 artifact set exported
    by ``lora/interop.py`` and a motion checkpoint, all written here and
    read back by the CLIs. The noise of a seed is drawn on the CPU, so
    both runs start from the same latents."""
    from video_style_transfer_tpu_torch.cli import common, infer, infer_video
    from video_style_transfer_tpu_torch.cli.verify_parity import (
        make_synthetic_checkpoint)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.utils.checkpoint import (
        export_motion_checkpoint)

    ckpt = make_synthetic_checkpoint(os.path.join(tmp, "tiny_sdxl"))
    art = os.path.join(tmp, "tiny_stage1")
    ucfg = common.tiny_checkpoint_configs(motion=True)[0]
    write_lora_artifacts(art, ucfg, rank=4, seed=1, device="cpu")
    motion = os.path.join(tmp, "tiny_motion", "motion_modules.safetensors")
    export_motion_checkpoint(motion, init_unet(Init(5), ucfg))
    shared = ["--pretrained_model_name_or_path", ckpt, "--config_preset",
              "tiny", "--unziplora_name_or_path", art]
    image_args = shared + [
        "--mode", "both", "--prompt", "a dog in watercolor style",
        "--prompt_content", "a dog", "--prompt_style", "watercolor style",
        "--sampler", "dpm", "--num_inference_steps", "3", "--resolution",
        "32", "--seeds", "7"]
    video_args = shared + [
        "--motion_checkpoint", motion, "--modes", "style", "--prompt",
        "a horse in the snow", "--num_frames", "4", "--resolution", "16",
        "--num_inference_steps", "2", "--mixed_precision", "no", "--seed",
        "7"]
    for label, cli, argv, key in (("image", infer, image_args, "both_seed7"),
                                  ("video", infer_video, video_args,
                                   "style")):
        outs, folded = {}, {}
        for dev in ("cuda", "cpu"):
            report = {}
            outs[dev] = cli.generate(cli.build_parser().parse_args(
                argv + ["--device", dev]), report)[key]
            folded[dev] = (report["n_folded"] if label == "image"
                           else report[key]["n_folded"])
        diff = int(abs(outs["cuda"].astype(int)
                       - outs["cpu"].astype(int)).max())
        print(f"small-input {label} CLI reference: tiny checkpoint, rank-4 "
              f"artifacts and tokenizers from files, {folded['cuda']} "
              f"projections folded, output {outs['cuda'].shape}, cuda vs "
              f"cpu max difference {diff} levels (limit 2)", flush=True)
        if diff > 2 or folded["cuda"] != folded["cpu"] or not folded["cuda"]:
            fail(f"tiny {label} CLI on cuda differs from cpu by {diff} "
                 f"levels (folded {folded})")
        if float(outs["cuda"].std()) == 0.0:
            fail(f"tiny {label} CLI output is constant")


def small_training_reference():
    """One tiny stage-2 loss and backward on the card (fp32: every kernel
    of the path, K1-K5) against the same on the CPU (the plain versions),
    from the same weights, LoRAs, batch and draws, all drawn on the CPU.
    The tiny UNet is widened at level 1 to 128 channels in 2 heads (d =
    64) and fed 64^2 latents, so that its self-attention (1024 tokens)
    takes the flash kernels and its motion modules (d = 16) the temporal
    ones."""
    import torch
    from video_style_transfer_tpu_torch.config import UNetConfig
    from video_style_transfer_tpu_torch.lora.surgery import (
        insert_temporal_lora, insert_unziplora, iter_motion_attention_paths,
        spatial_pairs, tree_get)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
    from video_style_transfer_tpu_torch.training import stage2
    from video_style_transfer_tpu_torch.utils.convert import to_device

    cfg = UNetConfig.tiny(use_motion_modules=True,
                          block_out_channels=(32, 128),
                          num_attention_heads=(2, 2))
    params = init_unet(Init(0), cfg)
    params, state = insert_unziplora(params, Init(1), rank=4)
    insert_temporal_lora(params, Init(2), rank=4)
    ini = Init(3)
    for path in iter_motion_attention_paths(params):
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            tl = tree_get(params, path + (proj, "tlora"))
            tl["b"] = ini.normal(tuple(tl["b"].shape), 0.05)
    g = torch.Generator().manual_seed(4)
    batch = {"latents": torch.randn(1, 2, 64, 64, 4, generator=g),
             "ctx": torch.randn(1, 7, 32, generator=g),
             "pooled": torch.randn(1, 32, generator=g),
             "uncond_ctx": torch.randn(1, 7, 32, generator=g),
             "uncond_pooled": torch.randn(1, 32, generator=g),
             "time_ids": torch.tensor([[512., 512, 0, 0, 512, 512]])}
    draws = stage2.draw_stage2(make_schedule(), (1, 2, 64, 64, 4),
                               cfg_dropout=0.1, generator=g, device="cpu")
    mask = stage2.trainable_mask(params)

    def run(dev):
        p = to_device(params, dev)
        trainable = stage2.split_trainable(p, mask)
        loss, _ = stage2.stage2_loss(
            p, cfg, make_schedule(), to_device(batch, dev),
            to_device(draws, dev), pairs=spatial_pairs(p), lambda_orth=0.1,
            mode="both", state=to_device(state, dev), remat=True)
        loss.backward()
        return loss.item(), [(path, t.grad.cpu()) for path, t in trainable]

    reset_counters()
    gpu_loss, gpu_grads = run(torch.device("cuda"))
    used = counters()
    cpu_loss, cpu_grads = run(torch.device("cpu"))
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(gpu_grads, cpu_grads):
        scale = float(b.abs().max())
        err = float((a - b).abs().max()) / max(scale, 1e-12)
        if err > worst:
            worst, where = err, path
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"small-input training reference: tiny stage-2 step (fp32, "
          f"remat blocks), cuda vs cpu loss rel err {loss_err:.2e} (limit "
          f"1e-5), worst gradient error {worst:.2e} of the tensor's max "
          f"(limit 1e-4, at {'.'.join(map(str, where or ()))}) over "
          f"{len(gpu_grads)} trainable tensors; kernel launches on the "
          f"card {used}", flush=True)
    if not (loss_err <= 1e-5 and worst <= 1e-4):
        fail("tiny stage-2 step on cuda differs from cpu")
    # what a training step runs: the attention and feed-forward kernels
    # and their backwards (no model calls K7)
    for name in ("flash_attention_fwd", "flash_attention_bwd",
                 "geglu_projection", "temporal_attention",
                 "temporal_attention_bwd"):
        if used[name] <= 0:
            fail(f"kernel {name} was not launched by the tiny stage-2 step")


def expected_train_launches(cfg, *, frames, resolution, steps,
                            encoded=None):
    """Kernel launches of `steps` stage-2 steps at B = 1, from the UNet's
    block counts: spatial self-attentions of >= 1024 tokens and d % 64 ==
    0 take K1/K4, every spatial and motion feed-forward K2, every motion
    attention K3/K5 (d % 8 == 0), and each frame through the VAE encoder
    its mid-block attention K1: `encoded` frames (default: every frame of
    every step, as without the moment cache). The trainer stores every
    activation (no remat), so each forward runs once per step."""
    from video_style_transfer_tpu_torch.config import CROSS
    if encoded is None:
        encoded = steps * frames
    lat = resolution // 8
    flash = spatial = motion = 0
    levels = [(i, cfg.layers_per_block, t) for i, t in
              enumerate(cfg.down_block_types)]
    levels += [(len(cfg.up_block_types) - 1 - i, cfg.layers_per_block + 1, t)
               for i, t in enumerate(cfg.up_block_types)]
    for lvl, n_groups, btype in levels:
        motion += n_groups if cfg.use_motion_modules else 0
        if btype == CROSS:
            layers = n_groups * cfg.transformer_layers_per_block[lvl]
            spatial += layers
            tokens = (lat >> lvl) ** 2
            d = cfg.block_out_channels[lvl] // cfg.num_attention_heads[lvl]
            if tokens >= 1024 and d % 64 == 0:
                flash += layers
    mid = cfg.transformer_layers_per_block[-1]
    spatial += mid
    d = cfg.block_out_channels[-1] // cfg.num_attention_heads[-1]
    if (lat >> (len(cfg.block_out_channels) - 1)) ** 2 >= 1024 and \
            d % 64 == 0:
        flash += mid
    return {"flash_attention_fwd": steps * flash + encoded,
            "geglu_projection": steps * (spatial + motion),
            "temporal_attention": steps * 2 * motion,
            "flash_attention_bwd": steps * flash,
            "flash_attention_bwd_delta": steps * flash,
            "temporal_attention_bwd": steps * 2 * motion}


class ArrayClips:
    """A clip source with VideoClipDataset's interface over one video held
    as raw BGR uint8 frames (F, H, W, 3) in memory, as cv2 decodes them:
    every start of `num_frames` consecutive frames, drawn by seed as
    VideoClipDataset draws them and preprocessed as its native path does
    (data/native.py preprocess_frames_bgr: bilinear resize, BGR -> RGB,
    [-1, 1]); a frame's id is (0, its index)."""

    def __init__(self, frames, num_frames):
        self.frames = frames
        self.num_frames = num_frames
        self.starts = list(range(len(frames) - num_frames + 1))

    def __len__(self):
        return len(self.starts)

    def sample_batch_meta(self, batch_size, seed):
        import numpy as np
        from video_style_transfer_tpu_torch.data import native
        idx = np.random.RandomState(seed).randint(0, len(self),
                                                  size=batch_size)
        f = self.num_frames
        h, w = self.frames.shape[1:3]
        clips = [native.preprocess_frames_bgr(
            self.frames[self.starts[i]:self.starts[i] + f], h, w)
            for i in idx]
        ids = [[(0, self.starts[i] + j) for j in range(f)] for i in idx]
        return np.stack(clips), ids


def _tree_equal(a, b):
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    return a == b


def stage2_path(tmp):
    """The stage-2 trainer at full width on one seeded 10-frame 1024²
    video held in memory: one epoch (its 3 clip starts, 3 steps) through
    the latent-moment cache with a checkpoint at step 2, then a run
    resumed from the latest checkpoint to step 4. Checks that the frozen
    tensors stay bitwise unchanged, the f32 temporal-LoRA b tensors move,
    the losses are finite, every kernel launches as often as the block
    counts and the cache's misses say (K1's FMA route once per encoded
    frame), the resumed run restores the trainable tensors and optimizer
    state bitwise as saved, the checkpoint directory holds the two
    committed checkpoints and nothing else, metrics.jsonl one finite line
    per logged step, and the motion checkpoint it writes holds the
    trained weights with the temporal LoRA folded in; then runs the 8-bit
    AdamW phase on the trained tensors. Returns (launch counts, motion
    checkpoint path, 8-bit AdamW readings)."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.cli import train_animatediff
    from video_style_transfer_tpu_torch.cli.common import model_configs
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    from video_style_transfer_tpu_torch.training.stage2 import iter_leaves
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt
    from video_style_transfer_tpu_torch.utils.motion_convert import (
        fold_temporal_lora, import_motion_state_dict, load_motion_checkpoint)

    out_dir = os.path.join(tmp, "stage2")
    video = np.random.default_rng(3).integers(
        0, 256, (TRAIN_VIDEO_FRAMES, RESOLUTION, RESOLUTION, 3),
        dtype=np.uint8)
    clips = ArrayClips(video, TRAIN_FRAMES)
    argv = ["--output_dir", out_dir,
            "--prompt", "a horse galloping through a snowy forest",
            "--num_frames", str(TRAIN_FRAMES), "--resolution",
            str(RESOLUTION), "--lr_warmup_steps", "1", "--device", "cuda",
            "--seed", "0", "--log_every", "1", "--checkpointing_steps",
            str(TRAIN_CKPT_EVERY)]
    parser = train_animatediff.build_parser()
    snap = {}

    def on_setup(tr):
        names = {p for p, _ in tr.trainable}
        for path, t in iter_leaves(tr.params):
            snap[path] = (path in names, t.detach().to("cpu", copy=True))

    report = {}
    reset_counters()
    t0 = time.perf_counter()
    tr = train_animatediff.train(
        parser.parse_args(argv + ["--num_train_epochs", "1"]), report,
        on_setup, dataset=clips)
    total = time.perf_counter() - t0
    counts = counters()
    cfg = model_configs(smoke=False, motion=True)[0]
    encoded = sum(report["encoded_frames"])
    if tr.max_steps != TRAIN_STEPS or len(report["loss"]) != TRAIN_STEPS:
        fail(f"one epoch over {len(clips)} clip starts ran "
             f"{len(report['loss'])} steps, expected {TRAIN_STEPS}")
    if encoded != tr.cache.misses or encoded > TRAIN_VIDEO_FRAMES:
        fail(f"the moment cache encoded {encoded} frames (misses "
             f"{tr.cache.misses}), at most {TRAIN_VIDEO_FRAMES} expected")
    expected = expected_train_launches(cfg, frames=TRAIN_FRAMES,
                                       resolution=RESOLUTION,
                                       steps=TRAIN_STEPS, encoded=encoded)
    card = card_line()
    print(f"stage-2 path ({card}): one epoch of {len(clips)} clip starts of "
          f"a {TRAIN_VIDEO_FRAMES}-frame {RESOLUTION}^2 video in memory; "
          f"set-up {report['weight_init_s']:.3f} s; checkpoints "
          f"{[os.path.basename(c) for c in report['checkpoints']]}; per "
          f"step encoded frames {report['encoded_frames']} (cache hits "
          f"{tr.cache.hits}, misses {tr.cache.misses}), clip encode "
          f"{', '.join(f'{s:.4f}' for s in report['encode_s'])} s, train "
          f"steps {', '.join(f'{s:.4f}' for s in report['step_s'])} s, "
          f"iteration {', '.join(f'{a + b:.4f}' for a, b in zip(report['encode_s'], report['step_s']))} "
          f"s; checkpoint writes "
          f"{', '.join(f'{s:.3f}' for s in report['checkpoint_s'])} s; "
          f"total {total:.3f} s, peak memory "
          f"{report.get('peak_memory_gib', 0):.2f} GiB (no remat), "
          f"{report['trainable_tensors']} trainable tensors "
          f"({report['trainable_params']} params), losses {report['loss']}",
          flush=True)
    cached = [(e, s) for e, s, n in zip(report["encode_s"], report["step_s"],
                                        report["encoded_frames"]) if n == 0]
    full = [(e, s) for e, s, n in zip(report["encode_s"], report["step_s"],
                                      report["encoded_frames"])
            if n == TRAIN_FRAMES]
    # the host's share of the encode phase: drawing and normalising a clip
    sample_s = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        clips.sample_batch_meta(1, step)
        sample_s.append(time.perf_counter() - t0)
    print(f"stage-2 iteration ({card}): a step whose clip was all cached "
          f"{[f'{e:.4f} + {s:.4f} s' for e, s in cached]} (encode + step), "
          f"a step that encoded all {TRAIN_FRAMES} frames "
          f"{[f'{e:.4f} + {s:.4f} s' for e, s in full]}; of the encode "
          f"phase, drawing and normalising the clip on the host takes "
          f"{', '.join(f'{t:.4f}' for t in sample_s)} s", flush=True)
    print(f"launches on the stage-2 path, first run: {counts} (expected "
          f"{expected})", flush=True)
    if not all(map(math.isfinite, report["loss"])):
        fail(f"non-finite stage-2 losses {report['loss']}")
    for name, n in counts.items():
        if n != expected.get(name, 0):
            fail(f"kernel {name} launched {n} times on the stage-2 path, "
                 f"expected {expected.get(name, 0)}")
    frozen_moved, b_still, bf16_changed, bf16_total = 0, 0, 0, 0
    for path, t in iter_leaves(tr.params):
        was_trainable, before = snap[path]
        same = torch.equal(t.detach().cpu(), before)
        if not was_trainable:
            frozen_moved += not same
        elif path[-2:-1] == ("tlora",) and path[-1] == "b":
            b_still += same
        elif t.dtype == torch.bfloat16:
            bf16_total += 1
            bf16_changed += not same
    n_b = sum(1 for p, _ in tr.trainable if p[-1] == "b" and "tlora" in p)
    print(f"after {TRAIN_STEPS} steps: {frozen_moved} of "
          f"{sum(1 for w, _ in snap.values() if not w)} frozen tensors "
          f"changed (must be 0); {n_b - b_still} of {n_b} f32 temporal-LoRA "
          f"b tensors moved (must be all); {bf16_changed} of {bf16_total} "
          f"bf16 trainable tensors changed (reported only: a ~2e-5 Adam "
          f"step is below half a bf16 ulp for most weights)", flush=True)
    if frozen_moved or b_still:
        fail("stage-2 training moved frozen tensors or left temporal-LoRA "
             "b tensors unchanged")
    first_logged = len(report["loss"])
    del tr
    torch.cuda.empty_cache()

    # the resumed run: its restored state against the file it came from
    saved_path = os.path.join(out_dir, "checkpoints",
                              f"checkpoint-{TRAIN_CKPT_EVERY}")
    restored = {}

    def on_resume(tr):
        saved = torch.load(os.path.join(saved_path, ckpt.STATE_FILE),
                           map_location="cpu", weights_only=True)
        live = ckpt.train_state(tr.trainable, tr.optimizer, tr.start)
        restored.update(
            start=tr.start, path=tr.resumed_from,
            trainable=_tree_equal(live["trainable"], saved["trainable"]),
            optimizer=_tree_equal(live["optimizer_state"],
                                  saved["optimizer_state"]),
            tensors=len(saved["trainable"]))

    resume_report = {}
    t0 = time.perf_counter()
    tr = train_animatediff.train(
        parser.parse_args(argv + ["--max_train_steps", str(TRAIN_RESUME_TO),
                                  "--resume_from_checkpoint", "latest"]),
        resume_report, on_resume, dataset=clips)
    resume_total = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(out_dir, "checkpoints")))
    want_names = [f"checkpoint-{TRAIN_CKPT_EVERY}",
                  f"checkpoint-{TRAIN_RESUME_TO}"]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        logged = [json.loads(ln) for ln in f.read().splitlines()]
    resumed_steps = len(resume_report["loss"])
    print(f"stage-2 resume ({card}): from {restored.get('path')} at step "
          f"{restored.get('start')}, {restored.get('tensors')} trainable "
          f"tensors and the {tr.optimizer.kind} state restored bitwise as "
          f"saved: {restored.get('trainable')} / "
          f"{restored.get('optimizer')}; steps "
          f"{resume_report['start_step']}..{TRAIN_RESUME_TO - 1}: encoded "
          f"frames {resume_report['encoded_frames']}, clip encode "
          f"{', '.join(f'{s:.4f}' for s in resume_report['encode_s'])} s, "
          f"train steps "
          f"{', '.join(f'{s:.4f}' for s in resume_report['step_s'])} s, "
          f"set-up {resume_report['weight_init_s']:.3f} s, total "
          f"{resume_total:.3f} s; checkpoints/ holds {names}; "
          f"metrics.jsonl {len(logged)} lines for "
          f"{first_logged + resumed_steps} logged steps", flush=True)
    if not (restored.get("start") == TRAIN_CKPT_EVERY
            and restored.get("trainable") and restored.get("optimizer")):
        fail(f"the resumed run did not restore checkpoint-"
             f"{TRAIN_CKPT_EVERY} bitwise: {restored}")
    if names != want_names:
        fail(f"checkpoints/ holds {names}, expected {want_names}")
    if resumed_steps != TRAIN_RESUME_TO - TRAIN_CKPT_EVERY or \
            resume_report["checkpoints"][-1] != os.path.join(
                out_dir, "checkpoints", want_names[-1]):
        fail(f"the resumed run took {resumed_steps} steps and wrote "
             f"{resume_report['checkpoints']}")
    keys = ("loss", "loss_mse", "loss_orth", "sec_per_step")
    if len(logged) != first_logged + resumed_steps or not all(
            math.isfinite(ln[k]) for ln in logged for k in keys):
        fail(f"metrics.jsonl: {len(logged)} lines, expected "
             f"{first_logged + resumed_steps} with finite {keys}")
    if not all(map(math.isfinite, resume_report["loss"])):
        fail(f"non-finite resumed losses {resume_report['loss']}")
    # the whole path: both runs' steps, the cache misses of each
    counts = counters()
    encoded += sum(resume_report["encoded_frames"])
    expected = expected_train_launches(
        cfg, frames=TRAIN_FRAMES, resolution=RESOLUTION,
        steps=TRAIN_STEPS + resumed_steps, encoded=encoded)
    print(f"launches on the stage-2 path, both runs: {counts} (expected "
          f"{expected}; K1's FMA route {encoded} encoded frames, "
          f"{(TRAIN_STEPS + resumed_steps) * TRAIN_FRAMES} without the "
          f"cache)", flush=True)
    for name, n in counts.items():
        if n != expected.get(name, 0):
            fail(f"kernel {name} launched {n} times on the stage-2 path, "
                 f"expected {expected.get(name, 0)}")
    motion_checkpoint = resume_report["motion_checkpoint"]
    folded = fold_temporal_lora(tr.params)
    written = load_motion_checkpoint(motion_checkpoint)
    reimported = import_motion_state_dict(tr.params, written)
    motion = [(path, t) for path, t in iter_leaves(folded)
              if "motion_modules" in path]
    differing = [path for path, t in motion
                 if not torch.equal(t, tree_get(reimported, path))]
    print(f"motion checkpoint: {motion_checkpoint} written in "
          f"{resume_report['export_s']:.3f} s, {len(written)} tensors, "
          f"{sum(v.size for v in written.values())} parameters; read back "
          f"and re-imported, {len(differing)} of {len(motion)} motion "
          f"tensors differ from the trainer's weights with the temporal "
          f"LoRA folded in (must be 0)", flush=True)
    if differing or len(written) != len(motion):
        fail(f"the motion checkpoint differs from the trained weights, "
             f"e.g. {differing[:3]}")
    counts = check_routes("stage-2", counts,
                          expected["flash_attention_bwd"], encoded,
                          bwd_wgmma=expected["flash_attention_bwd"])
    adam8 = adamw8bit_phase([t for _, t in tr.trainable], card)
    return counts, motion_checkpoint, adam8


def stage1_launches(per, *, train_forwards, unet_calls, vae_calls):
    """Launches of `train_forwards` stage-1 training forwards (each with
    its backward), `unet_calls` inference UNet calls (a CFG pair in one)
    and `vae_calls` VAE encodes or decodes at 1024^2 (one mid-block
    attention each), from `per`, one training forward's
    (expected_train_launches at one step and no encode)."""
    fwd = train_forwards + unet_calls
    return {"flash_attention_fwd": per["flash_attention_fwd"] * fwd
            + vae_calls,
            "geglu_projection": per["geglu_projection"] * fwd,
            "temporal_attention": 0,
            "flash_attention_bwd": per["flash_attention_bwd"]
            * train_forwards,
            "flash_attention_bwd_delta": per["flash_attention_bwd_delta"]
            * train_forwards,
            "temporal_attention_bwd": 0, "layer_norm": 0}


def stage1_selection_phase(captured, chosen, sep, card):
    """Run D: the selection arithmetic of one projection after another
    (training.stage1.select_projection: the cone in float64, top-k) from
    the gradients and tensors run A held at its selection step. On the
    card, the masks must be those run A chose. With seeded random
    weights at rank 64 the cone stays far below its 1e-5 threshold (the
    largest |cone| is printed) and nothing is selected, so the arithmetic
    runs again with the gradients scaled by a power of two (exact) that
    brings the largest |cone| to [1e-3, 2e-3), on the card and on the
    CPU: masks and scores must be equal on both, ties and all. Returns
    (the readings, the card's scaled selection {path: (score_content,
    score_style, mask_content, mask_style)} on the CPU)."""
    import torch
    from video_style_transfer_tpu_torch.lora.unzip import (
        CONE_THRESHOLD, cone_matrix)
    from video_style_transfer_tpu_torch.training.stage1 import (
        select_projection)
    from video_style_transfer_tpu_torch.utils.convert import to_device

    def cone_max(lp, lg, factor=1.0):
        lg = {k: ({kk: vv * factor for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.zeros_like(v))
              for k, v in to_device(lg, "cuda").items()}
        lp = to_device(lp, "cuda")
        return max(float(cone_matrix(lp, lg, b, torch.float64).abs().max())
                   for b in ("content", "style"))

    largest = max(cone_max(lp, lg) for lp, lg, _, _ in captured.values())
    scale = 2.0 ** math.ceil(math.log2(1e-3 / largest)) if largest else 1.0

    def select_all(dev, factor):
        out = {}
        for path, (lp, lg, st, label) in captured.items():
            g = to_device(lg, dev)
            if factor != 1.0:
                g = {k: ({kk: vv * factor for kk, vv in v.items()}
                         if isinstance(v, dict) else v * factor)
                     for k, v in g.items()}
            picked = select_projection(to_device(lp, dev), g,
                                       to_device(st, dev), label, sep)
            out[path] = [t.cpu() for t in picked]
        return out

    def columns(picked):
        return {b: int(sum(int(v[2 + i].sum()) for v in picked.values()))
                for i, b in enumerate(("content", "style"))}

    readings = {"largest_abs_cone": largest, "scale": scale}
    t0 = time.perf_counter()
    on_card = select_all("cuda", 1.0)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    differ = [path for path, picked in on_card.items()
              if not (torch.equal(picked[2], chosen[path][0])
                      and torch.equal(picked[3], chosen[path][1]))]
    cols = columns(on_card)
    print(f"stage-1 selection as trained, on the card ({card}): run A's "
          f"step {STAGE1_SELECT_STEP} gradients and tensors through the "
          f"cone (float64) and top-k of {len(on_card)} projections: "
          f"{len(differ)} differ in a mask from the trainer's (must be 0); "
          f"largest |cone| {largest:.3e} (threshold 1e-5); columns "
          f"selected content {cols['content']}, style {cols['style']}; "
          f"{card_s:.3f} s", flush=True)
    if differ:
        fail(f"stage-1 selection on the card differs from the trainer's at "
             f"{[chip_path(p) for p in differ[:3]]}")
    readings["as trained"] = {"projections": len(on_card),
                              "differing": 0, "columns": cols,
                              "card_s": card_s}

    scaled = max(cone_max(lp, lg, scale)
                 for lp, lg, _, _ in captured.values())
    t0 = time.perf_counter()
    on_card = select_all("cuda", scale)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = select_all("cpu", scale)
    cpu_s = time.perf_counter() - t0
    differ = [path for path, picked in on_cpu.items()
              if not all(torch.equal(a, b)
                         for a, b in zip(picked, on_card[path]))]
    cols = columns(on_card)
    scored = sum(int((v[i] > 0).sum()) for v in on_card.values()
                 for i in (0, 1))
    print(f"stage-1 selection gradients scaled (x{scale:g}), card vs CPU "
          f"({card}): {len(differ)} of {len(on_card)} projections differ "
          f"in a mask or score between the card and the CPU (must be 0); "
          f"largest |cone| {scaled:.3e} (threshold 1e-5); {scored} nonzero "
          f"column scores; columns selected content {cols['content']}, "
          f"style {cols['style']}; {card_s:.3f} s on the card, "
          f"{cpu_s:.3f} s on the CPU", flush=True)
    for path in differ[:3]:
        # where the two devices part: which outputs, and the cone elements
        # that cross the threshold on one device only
        parts = {n: int((a != b).sum()) for n, a, b in zip(
            STAGE1_SELECTION_KEYS, on_cpu[path], on_card[path])
            if not torch.equal(a, b)}
        lp, lg, _, _ = captured[path]
        g = {k: ({kk: vv * scale for kk, vv in v.items()}
                 if isinstance(v, dict) else v * 0.0)
             for k, v in lg.items()}
        for b in ("content", "style"):
            cc = cone_matrix(to_device(lp, "cuda"), to_device(g, "cuda"),
                             b, torch.float64).cpu()
            cp = cone_matrix(lp, g, b, torch.float64)
            flip = (cc.abs() > CONE_THRESHOLD) != (cp.abs() > CONE_THRESHOLD)
            rel = float(((cc - cp).abs() / cp.abs().clamp_min(1e-300))
                        .max())
            print(f"    {chip_path(path)} {b}: differing {parts}; cone "
                  f"max relative difference card vs CPU {rel:.3e}, "
                  f"{int(flip.sum())} elements cross 1e-5 on one device "
                  f"only, e.g. card {cc[flip][:3].tolist()} CPU "
                  f"{cp[flip][:3].tolist()}", flush=True)
    if differ:
        fail(f"stage-1 selection (gradients scaled) differs between the "
             f"card and the CPU at {[chip_path(p) for p in differ[:3]]}")
    if scaled <= CONE_THRESHOLD:
        fail(f"stage-1 selection: the scaled gradients' largest |cone| "
             f"{scaled:.3e} is under the 1e-5 threshold")
    if not cols["content"]:
        fail("stage-1 selection with scaled gradients selected nothing")
    readings["gradients scaled"] = {
        "projections": len(on_card), "differing": 0, "columns": cols,
        "largest_abs_cone": scaled, "nonzero_scores": scored,
        "card_s": card_s, "cpu_s": cpu_s}
    return readings, on_card


def write_selection_checkpoint(tr_b, selected, out):
    """Run B's final state (its trainer `tr_b`) given run D's scaled
    selection `selected` (every projection's scores and masks, both masks
    in use, orth_on and merger_on set), written as a checkpoint under
    `out` through train_state. Returns (its path, its step, the mergers
    {path: {branch: CPU tensor}}, the write's seconds)."""
    import torch
    from video_style_transfer_tpu_torch.cli import train_unziplora
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt

    state = tr_b.state
    with torch.no_grad():
        for path, picked in selected.items():
            st = tree_get(state.lora_state, path)
            for key, val in zip(STAGE1_SELECTION_KEYS, picked):
                st[key].copy_(val)
            for b in ("content", "style"):
                st[f"use_mask_{b}"].fill_(True)
    state.orth_on = state.merger_on = True
    step = state.step
    mergers = {path: {b: tree_get(state.params, path)["lora"][f"merge_{b}"]
                      .detach().cpu().clone() for b in ("content", "style")}
               for path in selected}
    t0 = time.perf_counter()
    written = ckpt.save_checkpoint_main_process(
        os.path.join(out, "checkpoints"), ckpt.train_state(
            tr_b.optimizer.trainable, tr_b.optimizer, step,
            extra=train_unziplora.checkpoint_extra(state)), step)
    return written, step, mergers, time.perf_counter() - t0


def stage1_masked_run(written, step, mergers, selected, run, expect, routes,
                      out, images, card):
    """Run F: the trainer resumes from `written` (write_selection_
    checkpoint's, at `step`) for one zero-out step with
    --with_finetune_mask (each merger's gradient and update gated by its
    branch's mask) and exports, and --final_inference_check reads the
    artifacts back bitwise. The restored state must equal the written
    one; after the step the masks must be partial (some columns live,
    some not), no merger may move outside its branch's mask and some
    inside it, and the exported up tensors must hold both zeroed (masked)
    and live rows. `run` is stage1_path's runner. Returns the
    readings."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.lora import interop
    from video_style_transfer_tpu_torch.lora.surgery import tree_get

    keys = STAGE1_SELECTION_KEYS
    restored = {}

    def on_resume(tr):
        restored.update(step=tr.state.step, flags=(tr.state.orth_on,
                                                   tr.state.merger_on))
        restored["state"] = all(
            torch.equal(tree_get(tr.state.lora_state, path)[key].cpu(), val)
            for path, picked in selected.items()
            for key, val in zip(keys, picked)) and all(
            bool(tree_get(tr.state.lora_state, path)[f"use_mask_{b}"])
            for path in selected for b in ("content", "style"))

    tr, rep, _ = run(
        "F (partial masks)", [
            "--output_dir", out, "--resume_from_checkpoint", written,
            "--max_train_steps", str(step + 1), "--with_finetune_mask",
            "--final_inference_check"],
        expect, routes, images=images, on_setup=on_resume)
    live = {b: 0 for b in ("content", "style")}
    moved_in = dict(live)
    moved_out = dict(live)
    total = 0
    for path in selected:
        st = tree_get(tr.state.lora_state, path)
        lp = tree_get(tr.state.params, path)["lora"]
        for b in ("content", "style"):
            mask = st[f"mask_{b}"].cpu()
            moved = lp[f"merge_{b}"].detach().cpu() != mergers[path][b]
            live[b] += int(mask.sum())
            moved_in[b] += int((moved & mask).sum())
            moved_out[b] += int((moved & ~mask).sum())
        total += int(mask.numel())
    rows = {}
    for b in ("content", "style"):
        ups = [v for k, v in interop.load_safetensors(
            rep["artifacts"][b]).items() if k.endswith(".lora.up.weight")]
        zero = sum(int(np.all(u == 0, axis=1).sum()) for u in ups)
        rows[b] = {"zeroed": zero, "live": sum(u.shape[0] for u in ups)
                   - zero}
    print(f"stage-1 partial masks ({card}): checkpoint-{step} with run D's "
          f"selection, restored as written "
          f"{restored.get('state')} (step {restored.get('step')}, orth_on "
          f"and merger_on {restored.get('flags')}); phase "
          f"{rep['phase']}; live columns {live} of {total} a branch; "
          f"mergers moved inside their masks {moved_in}, outside "
          f"{moved_out} (must be 0); exported up rows {rows}; artifacts "
          f"read back bitwise and generated: {rep['final_check']}",
          flush=True)
    if not (restored.get("state") and restored.get("step") == step
            and restored.get("flags") == (True, True)):
        fail(f"stage-1 run F did not restore the written selection: "
             f"{restored}")
    if rep["phase"] != ["zeroout"]:
        fail(f"stage-1 run F phases {rep['phase']}, expected ['zeroout']")
    if rep["selected_columns"][-1] != live or not all(
            0 < live[b] < total for b in live):
        fail(f"stage-1 run F: live columns {live} of {total}, the trainer "
             f"reports {rep['selected_columns'][-1]}")
    if any(moved_out.values()) or not any(moved_in.values()):
        fail(f"stage-1 run F: mergers moved outside their masks "
             f"{moved_out}, inside {moved_in}")
    if not all(r["zeroed"] and r["live"] for r in rows.values()):
        fail(f"stage-1 run F: the exported up rows are not partly masked: "
             f"{rows}")
    if not rep["final_check"]:
        fail("stage-1 run F: --final_inference_check did not run")
    del tr
    return {"step_s": rep["step_s"], "live_columns": live, "columns": total,
            "mergers_moved_inside": moved_in, "exported_up_rows": rows,
            "final_check": rep["final_check"]}


def chip_path(path):
    return ".".join(map(str, path))


def stage1_path(tmp):
    """Stage 1 (``cli.train_unziplora.train``) at SDXL's published widths
    with seeded random weights: rank 64, 1024^2, batch 1, the reference's
    learning rates (5e-5 / 5e-5 / 5e-3) and lambda 0.5, two seeded 1024^2
    instance images and two class images for the content prior (weight 1)
    held in memory.
    - Run A (bf16): 8 steps of the column separation at 2 sample times,
      so that every phase runs (reset, sampling, select, zeroout, twice);
      a checkpoint at steps 4 and 8; validation at step 8 in the three
      modes; the export.
    - Run B resumes from run A's checkpoint-4 to step 8: its restored
      LoRA leaves, three optimizer groups, masks, scores, use-mask flags,
      orth_on, merger_on and step equal the file's bitwise, its phases
      run A's; --final_inference_check reads the exported artifacts back
      (bitwise equal to the trained tensors) and generates.
    - Run D: run A's selection step recomputed from its gradients on the
      card and, from gradients scaled to cross the threshold, on the card
      and on the CPU (stage1_selection_phase).
    - Run F resumes from a checkpoint of run B's final state that holds
      run D's scaled selection (partial masks, in use, the mergers on):
      one zero-out step with --with_finetune_mask through the trainer,
      its merger updates gated by the masks (no merger moves outside
      them, some inside), the export's up tensors partly zeroed by the
      masks and read back bitwise by --final_inference_check.
    - Run C: --mixed_precision no, 2 steps without the column separation
      or a prior: K1, K4 and K2 on their 3xTF32 routes.
    - Run E: 2 steps with --optimizer adamw8bit, 2 with prodigy.
    Every run's kernel launches are exact (stage1_launches; K1's FMA
    route once per encoded or decoded image). Returns (launch counts by
    route, readings)."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.cli import train_unziplora
    from video_style_transfer_tpu_torch.cli.common import launches_since
    from video_style_transfer_tpu_torch.config import UNetConfig
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu
    from video_style_transfer_tpu_torch.training.stage1 import lora_grads
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt

    card = card_line()
    rng = np.random.default_rng(21)

    def seeded_images(n):
        return rng.integers(0, 256, (n, RESOLUTION, RESOLUTION, 3),
                            dtype=np.uint8).astype(np.float32) / 127.5 - 1.0

    images, class_images = seeded_images(2), {"content": seeded_images(2)}
    per = expected_train_launches(UNetConfig.sdxl(), frames=1,
                                  resolution=RESOLUTION, steps=1, encoded=0)
    shared = ["--instance_prompt", "a sbu horse in szn style",
              "--content_forward_prompt", "a sbu horse",
              "--style_forward_prompt", "an image in szn style",
              "--rank", str(LORA_RANK), "--resolution", str(RESOLUTION),
              "--train_batch_size", "1", "--content_learning_rate", "5e-5",
              "--style_learning_rate", "5e-5", "--weight_learning_rate",
              "5e-3", "--similarity_lambda", "0.5", "--device", "cuda",
              "--seed", "0"]
    sep_args = ["--with_period_column_separation", "--sample_times",
                str(STAGE1_SAMPLE_TIMES), "--max_train_steps",
                str(STAGE1_STEPS), "--checkpointing_steps", str(STAGE1_CKPT),
                "--validation_steps", str(STAGE1_VAL_STEPS)]
    prior_args = ["--class_prompt", "a horse", "--prior_loss_weight", "1.0"]
    parser = train_unziplora.build_parser()

    def route_counts():
        return {"K1": dict(fa.ROUTE_LAUNCHES), "K4": dict(
            fa.BWD_ROUTE_LAUNCHES), "K2": dict(geglu.ROUTE_LAUNCHES)}

    def run(label, argv, expect, routes, **kw):
        """One trainer run; its launches must equal `expect`, and its
        launches by route `routes` ({"K1": {route: n}, ...})."""
        before, rbefore = counters(), route_counts()
        report = {}
        t0 = time.perf_counter()
        tr = train_unziplora.train(parser.parse_args(shared + argv), report,
                                   **kw)
        total = time.perf_counter() - t0
        got = launches_since(before)
        rafter = route_counts()
        by_route = {k: {r: rafter[k][r] - rbefore[k].get(r, 0)
                        for r in rafter[k]} for k in rafter}
        want_routes = {k: {r: routes.get(k, {}).get(r, 0) for r in v}
                       for k, v in by_route.items()}
        losses = report["losses"]
        print(f"stage-1 run {label} ({card}): steps {report['start_step']}"
              f"..{report['max_steps'] - 1}, set-up {report['setup_s']:.3f} "
              f"s, encode {report['encode_s']:.3f} s, steps "
              f"{', '.join(f'{t:.4f}' for t in report['step_s'])} s "
              f"(drawing the latents "
              f"{', '.join(f'{t:.4f}' for t in report['sample_s'])} s), "
              f"phases {report['phase']}, checkpoint writes "
              f"{', '.join(f'{t:.3f}' for t in report['checkpoint_s'])} s, "
              f"validation {', '.join(f'{t:.3f}' for t in report['validation_s'])} "
              f"s, export {report['export_s']:.3f} s, total {total:.3f} s, "
              f"peak memory {report.get('peak_memory_gib', 0):.2f} GiB, "
              f"{report['trainable_tensors']} trainable tensors "
              f"({report['trainable_params']} params)", flush=True)
        keys = sorted(losses[0])
        print(f"  losses ({', '.join(keys)}): "
              f"{[[round(l[k], 6) for k in keys] for l in losses]}; columns "
              f"selected after each step {report['selected_columns']}",
              flush=True)
        print(f"  launches {got} (expected {expect}); by route {by_route} "
              f"(expected {want_routes})", flush=True)
        if not all(math.isfinite(v) for l in losses for v in l.values()):
            fail(f"stage-1 run {label}: non-finite losses")
        if got != expect:
            fail(f"stage-1 run {label}: launches {got}, expected {expect}")
        if by_route != want_routes:
            fail(f"stage-1 run {label}: launches by route {by_route}, "
                 f"expected {want_routes}")
        return tr, report, total

    def routes(k1, k4, k2, fma, route="wgmma"):
        return {"K1": {route: k1, "fma": fma}, "K4": {route: k4},
                "K2": {route: k2}}

    readings = {}
    reset_counters()
    # run A, holding the selection step's gradients and tensors for run D
    captured, chosen = {}, {}

    def on_grads(state, grads):
        if state.step == STAGE1_SELECT_STEP:
            for path, label in state_assignments[0].items():
                lp = tree_get(state.params, path)["lora"]
                cpu = {k: (v.detach().cpu().clone() if torch.is_tensor(v)
                           else {kk: vv.detach().cpu().clone()
                                 for kk, vv in v.items()})
                       for k, v in lp.items()}
                lg = {k: (v.cpu().clone() if torch.is_tensor(v)
                          else {kk: vv.cpu().clone() for kk, vv in v.items()})
                      for k, v in lora_grads(grads, path).items()}
                st = {k: v.cpu().clone() for k, v in
                      tree_get(state.lora_state, path).items()}
                captured[path] = (cpu, lg, st, label)
        elif state.step == STAGE1_SELECT_STEP + 1:
            for path in state_assignments[0]:
                st = tree_get(state.lora_state, path)
                chosen[path] = (st["mask_content"].cpu().clone(),
                                st["mask_style"].cpu().clone())

    state_assignments = []
    out_a = os.path.join(tmp, "stage1_a")
    forwards_a = 2 * STAGE1_STEPS
    val_calls = 3 * STAGE1_VAL_STEPS
    tr, rep_a, total_a = run(
        "A", sep_args + prior_args + [
            "--output_dir", out_a, "--validation_prompt",
            "a sbu horse in szn style", "--validation_epochs",
            str(STAGE1_STEPS)],
        stage1_launches(per, train_forwards=forwards_a, unet_calls=val_calls,
                        vae_calls=4 + 3),
        routes(per["flash_attention_fwd"] * (forwards_a + val_calls),
               per["flash_attention_bwd"] * forwards_a,
               per["geglu_projection"] * (forwards_a + val_calls), 4 + 3),
        images=images, class_images=class_images, on_grads=on_grads,
        on_setup=lambda t: state_assignments.append(t.assignments))
    sep = tr.sep
    if rep_a["phase"] != STAGE1_PHASES:
        fail(f"stage-1 run A phases {rep_a['phase']}, expected "
             f"{STAGE1_PHASES}")
    with open(os.path.join(out_a, "metrics.jsonl")) as f:
        logged = [json.loads(ln) for ln in f.read().splitlines()]
    scalars = [ln for ln in logged if "loss" in ln]
    if len(scalars) != 2 or not all(
            math.isfinite(v) for ln in scalars for k, v in ln.items()
            if k.startswith(("loss", "content_", "style_"))):
        fail(f"stage-1 metrics.jsonl: {len(scalars)} scalar lines, "
             f"expected 2 with finite losses, norms and merger means")
    vals = sorted(os.listdir(os.path.join(out_a, "validation")))
    print(f"stage-1 run A: metrics.jsonl {len(logged)} lines "
          f"({len(scalars)} of scalars: "
          f"{sum(k.endswith('_norm') for k in scalars[-1])} block norms, "
          f"{sum(k.endswith('_merge') for k in scalars[-1])} merger means), "
          f"validation images {vals}, artifacts "
          f"{sorted(os.path.basename(p) for p in rep_a['artifacts'].values())}",
          flush=True)
    if len(vals) != 3:
        fail(f"stage-1 validation wrote {vals}")
    readings["A"] = {k: rep_a.get(k) for k in (
        "setup_s", "encode_s", "step_s", "sample_s", "phase",
        "checkpoint_s", "validation_s", "export_s", "peak_memory_gib",
        "selected_columns")}
    readings["A"]["losses"] = rep_a["losses"]
    del tr
    torch.cuda.empty_cache()

    # run D: run A's selection on the card, and scaled on the card and CPU
    readings["D"], selected = stage1_selection_phase(captured, chosen, sep,
                                                     card)
    del captured

    # run B: resumed from checkpoint-4, restored bitwise, to step 8
    saved_path = os.path.join(out_a, "checkpoints",
                              f"checkpoint-{STAGE1_CKPT}")
    restored = {}

    def on_resume(tr):
        saved = torch.load(os.path.join(saved_path, ckpt.STATE_FILE),
                           map_location="cpu", weights_only=True)
        live = ckpt.train_state(
            tr.optimizer.trainable, tr.optimizer, tr.state.step,
            extra=train_unziplora.checkpoint_extra(tr.state))
        restored.update(
            step=tr.state.step, path=tr.resumed_from,
            trainable=_tree_equal(live["trainable"], saved["trainable"]),
            optimizer=_tree_equal(live["optimizer_state"],
                                  saved["optimizer_state"]),
            lora_state=_tree_equal(live["extra"]["lora_state"],
                                   saved["extra"]["lora_state"]),
            flags=_tree_equal(live["extra"]["flags"],
                              saved["extra"]["flags"]),
            kind=saved["optimizer"])

    forwards_b = 2 * (STAGE1_STEPS - STAGE1_CKPT)
    tr, rep_b, _ = run(
        "B", sep_args + prior_args + [
            "--output_dir", os.path.join(tmp, "stage1_b"),
            "--resume_from_checkpoint", saved_path,
            "--checkpointing_steps", str(STAGE1_STEPS + 1),
            "--final_inference_check"],
        stage1_launches(per, train_forwards=forwards_b,
                        unet_calls=STAGE1_VAL_STEPS, vae_calls=4 + 1),
        routes(per["flash_attention_fwd"] * (forwards_b + STAGE1_VAL_STEPS),
               per["flash_attention_bwd"] * forwards_b,
               per["geglu_projection"] * (forwards_b + STAGE1_VAL_STEPS),
               4 + 1),
        images=images, class_images=class_images, on_setup=on_resume)
    print(f"stage-1 resume ({card}): from {restored.get('path')} at step "
          f"{restored.get('step')}, bitwise as saved: LoRA leaves "
          f"{restored.get('trainable')}, the three {restored.get('kind')} "
          f"groups {restored.get('optimizer')}, masks, scores and use-mask "
          f"flags {restored.get('lora_state')}, orth_on and merger_on "
          f"{restored.get('flags')}; phases {rep_b['phase']} (run A's steps "
          f"{STAGE1_CKPT}..{STAGE1_STEPS - 1}: "
          f"{rep_a['phase'][STAGE1_CKPT:]}); artifacts read back bitwise "
          f"equal to the trained tensors and generated: "
          f"{rep_b['final_check']}", flush=True)
    if not (restored.get("step") == STAGE1_CKPT and all(
            restored.get(k) for k in ("trainable", "optimizer", "lora_state",
                                      "flags"))):
        fail(f"stage-1 resume did not restore checkpoint-{STAGE1_CKPT} "
             f"bitwise: {restored}")
    if rep_b["phase"] != rep_a["phase"][STAGE1_CKPT:]:
        fail("stage-1 resumed phases differ from run A's")
    if not rep_b["final_check"]:
        fail("stage-1 --final_inference_check did not run")
    readings["B"] = {"restored": restored, "step_s": rep_b["step_s"],
                     "final_check": rep_b["final_check"]}

    # run F: one zero-out step under run D's scaled (partial) selection
    out_f = os.path.join(tmp, "stage1_f")
    written, step_f, mergers, write_s = write_selection_checkpoint(
        tr, selected, out_f)
    print(f"stage-1 run F's checkpoint ({card}): run B's final state with "
          f"run D's scaled selection, written in {write_s:.3f} s",
          flush=True)
    del tr
    torch.cuda.empty_cache()
    readings["F"] = stage1_masked_run(
        written, step_f, mergers, selected,
        lambda label, argv, expect, routes_, **kw: run(
            label, sep_args + argv, expect, routes_, **kw),
        stage1_launches(per, train_forwards=1, unet_calls=STAGE1_VAL_STEPS,
                        vae_calls=2 + 1),
        routes(per["flash_attention_fwd"] * (1 + STAGE1_VAL_STEPS),
               per["flash_attention_bwd"],
               per["geglu_projection"] * (1 + STAGE1_VAL_STEPS), 2 + 1),
        out_f, images, card)
    readings["F"]["checkpoint_write_s"] = write_s
    del selected, mergers
    torch.cuda.empty_cache()

    # run C: fp32 (--mixed_precision no), every kernel on its 3xTF32 route
    forwards_c = STAGE1_SHORT
    tr, rep_c, _ = run(
        "C (fp32)", ["--output_dir", os.path.join(tmp, "stage1_c"),
                     "--max_train_steps", str(STAGE1_SHORT),
                     "--mixed_precision", "no"],
        stage1_launches(per, train_forwards=forwards_c, unet_calls=0,
                        vae_calls=2),
        {"K1": {"tf32x3": per["flash_attention_fwd"] * forwards_c,
                "fma": 2},
         "K4": {"tf32x3": per["flash_attention_bwd"] * forwards_c},
         "K2": {"tf32x3": per["geglu_projection"] * forwards_c}},
        images=images)
    readings["C"] = {"step_s": rep_c["step_s"],
                     "peak_memory_gib": rep_c.get("peak_memory_gib")}
    del tr
    torch.cuda.empty_cache()

    # run E: the other two optimizers
    readings["E"] = {}
    for opt in ("adamw8bit", "prodigy"):
        tr, rep_e, _ = run(
            f"E ({opt})", ["--output_dir", os.path.join(tmp, f"stage1_{opt}"),
                           "--max_train_steps", str(STAGE1_SHORT),
                           "--optimizer", opt],
            stage1_launches(per, train_forwards=STAGE1_SHORT, unet_calls=0,
                            vae_calls=2),
            routes(per["flash_attention_fwd"] * STAGE1_SHORT,
                   per["flash_attention_bwd"] * STAGE1_SHORT,
                   per["geglu_projection"] * STAGE1_SHORT, 2),
            images=images)
        readings["E"][opt] = {"step_s": rep_e["step_s"],
                              "losses": rep_e["losses"]}
        del tr
        torch.cuda.empty_cache()

    # the whole path, by route since the counters were set to 0
    train_fwd = forwards_a + forwards_b + 1 + 2 * STAGE1_SHORT
    unet = val_calls + 2 * STAGE1_VAL_STEPS
    vae = (4 + 3) + (4 + 1) + (2 + 1) + 2 + 2 * 2
    counts = counters()
    check_counts("stage-1", counts, stage1_launches(
        per, train_forwards=train_fwd + forwards_c, unet_calls=unet,
        vae_calls=vae))
    counts = check_routes(
        "stage-1", counts, per["flash_attention_fwd"] * (train_fwd + unet),
        vae,
        bwd_wgmma=per["flash_attention_bwd"] * train_fwd,
        tf32x3=per["flash_attention_fwd"] * forwards_c,
        bwd_tf32x3=per["flash_attention_bwd"] * forwards_c,
        geglu_tf32x3=per["geglu_projection"] * forwards_c)
    return counts, readings


def adamw8bit_phase(params, card):
    """Three ``--optimizer adamw8bit`` steps (training/adam8bit.py) over
    copies of the trained stage-2 tensors, on the card and on the CPU,
    from the same values and seeded gradients (global norm
    ADAM8_GRAD_NORM, so the clip passes them unchanged). The codes must be
    equal, the scales and the updated tensors within 1e-6, and the 8-bit
    state smaller than fp32 moments. Times one step on the card against
    the fp32 AdamW's on the same tensors. Returns the readings."""
    import torch
    from video_style_transfer_tpu_torch.training.stage2 import (
        make_optimizer)

    gen = torch.Generator().manual_seed(17)
    n = sum(p.numel() for p in params)
    scale = ADAM8_GRAD_NORM / math.sqrt(n)
    grads = [[(torch.randn(p.shape, generator=gen) * scale).to(p.dtype)
              for p in params] for _ in range(3)]
    cpu = [p.detach().to("cpu", copy=True) for p in params]
    gpu = [p.detach().clone() for p in params]
    kw = dict(lr=2e-5, total_steps=1000, warmup=1, optimizer="adamw8bit")
    opt_cpu, opt_gpu = make_optimizer(cpu, **kw), make_optimizer(gpu, **kw)
    t0 = time.perf_counter()
    for g in grads:
        opt_cpu.step(g)
    cpu_s = (time.perf_counter() - t0) / 3
    step_ms = []
    for g in grads:
        g = [x.cuda() for x in g]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_gpu.step(g)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    codes_off = scale_err = upd_err = 0.0
    for a, b in zip(opt_gpu.m + opt_gpu.v, opt_cpu.m + opt_cpu.v):
        if isinstance(a, dict):
            codes_off += int((a["q"].cpu() != b["q"]).sum())
            scale_err = max(scale_err, float((a["s"].cpu() - b["s"]).abs()
                                             .max()))
        else:
            scale_err = max(scale_err, float((a.cpu() - b).abs().max()))
    for a, b in zip(gpu, cpu):
        upd_err = max(upd_err, float((a.cpu().float() - b.float()).abs()
                                     .max()))
    moved = sum(not torch.equal(a.cpu(), p.cpu())
                for a, p in zip(gpu, params))
    fp32 = make_optimizer([p.detach().clone() for p in params],
                          total_steps=1000, warmup=1)
    fp32_ms = []
    for g in grads:
        g = [x.cuda() for x in g]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp32.step(g)
        torch.cuda.synchronize()
        fp32_ms.append((time.perf_counter() - t0) * 1e3)
    state8 = opt_gpu.state_bytes()
    state_fp32 = 8 * n
    state_adamw = sum(2 * p.numel() * p.element_size() for p in params)
    r = {"tensors": len(params), "params": n,
         "quantized_tensors": sum(opt_gpu.quantized(p) for p in params),
         "codes_differing": int(codes_off), "max_scale_err": scale_err,
         "max_update_err": upd_err, "tensors_moved": int(moved),
         "state_bytes_8bit": state8, "state_bytes_fp32": state_fp32,
         "state_bytes_adamw": state_adamw, "step_ms_8bit": step_ms,
         "step_ms_adamw": fp32_ms, "cpu_step_s": cpu_s}
    print(f"adamw8bit phase ({card}): 3 steps over the {len(params)} "
          f"trained stage-2 tensors ({n} params, "
          f"{r['quantized_tensors']} quantized) on the card and the CPU "
          f"from the same gradients: {r['codes_differing']} codes differ "
          f"(must be 0), scales and moments within {scale_err:.3e}, "
          f"tensors within {upd_err:.3e} (limit 1e-6), {moved} of "
          f"{len(params)} tensors moved; state {state8} bytes 8-bit vs "
          f"{state_fp32} fp32 moments ({state8 / state_fp32:.4f}; the "
          f"fp32 AdamW keeps each tensor's dtype: {state_adamw}); card "
          f"step {', '.join(f'{t:.2f}' for t in step_ms)} ms 8-bit, "
          f"{', '.join(f'{t:.2f}' for t in fp32_ms)} ms AdamW; CPU step "
          f"{cpu_s:.2f} s", flush=True)
    if codes_off or scale_err > 1e-6 or upd_err > 1e-6:
        fail("adamw8bit: the card and the CPU disagree")
    if not state8 < state_fp32 or not moved:
        fail(f"adamw8bit: state {state8} bytes against {state_fp32} fp32, "
             f"{moved} tensors moved")
    return r


def stage2_precision(artifacts):
    """The first stage-2 step's loss and trainable gradients in bf16 (the
    trainer's precision, as the reference's autocast) against fp32 (the
    JAX trainer's), at full width on the same weights, batch and draws,
    the stage-1 LoRA from the artifact set at `artifacts`
    (``cli.profile_step.precision_readings``). Cut: 2 frames instead of 8,
    so that the fp32 step, which stores every activation, fits one card.
    Fails on a gross fault (PRECISION_LIMITS); the readings, with the
    fp32 step's sensitivity to a 2^-20 nudge of its noise, are reported.
    This is also the path of --mixed_precision no in training: each fp32
    step's 70 spatial self-attentions take K1's and K4's 3xTF32 route and
    its 85 feed-forwards K2's, which the launch counts by route show.
    Returns (readings, launch counts)."""
    from video_style_transfer_tpu_torch.cli.common import model_configs
    from video_style_transfer_tpu_torch.cli.profile_step import (
        precision_readings)

    reset_counters()
    r = precision_readings([
        "--prompt", "a horse galloping through a snowy forest",
        "--num_frames", str(PRECISION_FRAMES), "--resolution",
        str(RESOLUTION), "--max_train_steps", "1", "--lr_warmup_steps", "1",
        "--unziplora_name_or_path", artifacts, "--device", "cuda",
        "--seed", "0"])
    print(f"stage-2 precision: first step at {PRECISION_FRAMES} frames "
          f"1024^2 with the rank-{LORA_RANK} artifact set, bf16 vs fp32 on "
          f"the same weights and draws: loss {r['loss_bf16']:.6f} vs "
          f"{r['loss_fp32']:.6f} (rel diff {r['loss_rel_diff']:.3e}, limit "
          f"{PRECISION_LIMITS[0]}), trainable gradients ({r['tensors']} "
          f"tensors, norm {r['grad_norm_bf16']:.4e} bf16 / "
          f"{r['grad_norm_fp32']:.4e} fp32) normwise "
          f"{r['grad_normwise_err']:.3e} (limit {PRECISION_LIMITS[1]}); "
          f"fp32 with the noise nudged by 2^-20: loss "
          f"{r['fp32_sensitivity_loss']:.3e}, gradients "
          f"{r['fp32_sensitivity_grad']:.3e} apart; step "
          f"{r['step_s_bf16']:.3f} s bf16 / {r['step_s_fp32']:.3f} s fp32, "
          f"peak {r['peak_gib']:.2f} GiB", flush=True)
    if not r["finite"]:
        fail("stage-2 precision: a non-finite loss or gradient")
    if not (r["loss_rel_diff"] <= PRECISION_LIMITS[0]
            and r["grad_normwise_err"] <= PRECISION_LIMITS[1]):
        fail("stage-2 precision: bf16 and fp32 steps apart beyond the "
             "gross-fault limits")
    # the clip's fp32 encode (one VAE attention a frame, the FMA route),
    # one bf16 step and two fp32 steps (the plain one and the nudged one)
    step = expected_train_launches(
        model_configs(smoke=False, motion=True)[0], frames=PRECISION_FRAMES,
        resolution=RESOLUTION, steps=1)
    flash = step["flash_attention_bwd"]
    counts = counters()
    if counts["geglu_projection"] != 3 * step["geglu_projection"]:
        fail(f"stage-2 precision: {counts['geglu_projection']} K2 launches, "
             f"expected {3 * step['geglu_projection']}")
    counts = check_routes("stage-2 precision", counts, flash,
                          PRECISION_FRAMES, bwd_wgmma=flash,
                          tf32x3=2 * flash, bwd_tf32x3=2 * flash,
                          geglu_tf32x3=2 * step["geglu_projection"])
    return {"frames": PRECISION_FRAMES, **r}, counts


def serving_launches(steps, frames):
    """Launches of one served video: per denoise step 70 spatial
    transformer blocks (one self-attention and one feed-forward each) and
    15 motion modules (two temporal attentions and one feed-forward
    each); the VAE mid-block attention once per decoded frame. Serving
    runs no backward and no model calls K7."""
    return {"flash_attention_fwd": 70 * steps + frames,
            "geglu_projection": 85 * steps,
            "temporal_attention": 30 * steps,
            "flash_attention_bwd": 0, "flash_attention_bwd_delta": 0,
            "temporal_attention_bwd": 0, "layer_norm": 0}


def check_counts(path, counts, expected):
    print(f"launches on the {path} path: {counts} (expected {expected})",
          flush=True)
    for name, n in counts.items():
        if n != expected[name]:
            fail(f"kernel {name} launched {n} times on the {path} path, "
                 f"expected {expected[name]}")


def main_path(artifacts, motion_checkpoint):
    """Video serving in every mode from the artifact set and the motion
    checkpoint on disk. Returns (launch counts by route, mode both's
    first UNet output, its latents before the decode and its
    frames)."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.cli import infer_video

    modes = ["base", "both", "content", "style"]
    args = infer_video.build_parser().parse_args([
        "--prompt", "a horse galloping through a snowy forest",
        "--content_prompt", "a horse galloping",
        "--style_prompt", "a snowy forest in watercolor",
        "--modes", *modes, "--unziplora_name_or_path", artifacts,
        "--motion_checkpoint", motion_checkpoint,
        "--num_frames", str(NUM_FRAMES),
        "--resolution", str(RESOLUTION), "--num_inference_steps", str(STEPS),
        "--guidance_scale", "7.5", "--device", "cuda", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    report, unet_outs = {}, []
    reset_counters()
    t0 = time.perf_counter()
    with kept_unet_outputs(unet_outs):
        outs = infer_video.generate(args, report)
    total = time.perf_counter() - t0
    counts = counters()
    print(f"main path: weight init, motion checkpoint and rank-{LORA_RANK} "
          f"LoRA import {report['weight_init_s']:.3f} s, total "
          f"{total:.3f} s for {len(modes)} modes, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    per_mode = serving_launches(STEPS, NUM_FRAMES)
    shape = (NUM_FRAMES, RESOLUTION, RESOLUTION, 3)
    for mode in modes:
        rep = report[mode]
        print(f"  {mode}: text encode {rep['text_encode_s']:.3f} s, fold "
              f"{rep['fold_s']:.3f} s ({rep['n_folded']} projections), "
              f"denoise steps "
              f"{', '.join(f'{t:.3f}' for t in rep['denoise_step_s'])} s "
              f"(step 1 includes the cross-attention k/v precompute), "
              f"decode {rep['decode_s']:.3f} s ({NUM_FRAMES} frames), "
              f"frames mean {float(outs[mode].mean()):.2f} std "
              f"{float(outs[mode].std()):.2f}", flush=True)
        # 70 blocks x (attn1, attn2) x (q, k, v, out)
        if rep["n_folded"] != (0 if mode == "base" else 560):
            fail(f"mode {mode} folded {rep['n_folded']} projections")
        if rep["kernel_launches"] != per_mode:
            fail(f"mode {mode} launched {rep['kernel_launches']}, expected "
                 f"{per_mode}")
        video = outs[mode]
        if video.shape != shape or str(video.dtype) != "uint8":
            fail(f"{mode} frames {video.shape} {video.dtype}, expected "
                 f"{shape} uint8")
        if float(video.std()) == 0.0:
            fail(f"{mode} frames are constant")
    for a in range(len(modes)):
        for b in range(a + 1, len(modes)):
            if np.array_equal(outs[modes[a]], outs[modes[b]]):
                fail(f"modes {modes[a]} and {modes[b]} gave the same frames")
    print(f"frames: {shape} uint8 per mode, finite before the cast, "
          f"pairwise different between {modes}", flush=True)
    check_counts("serving", counts,
                 {k: len(modes) * v for k, v in per_mode.items()})
    routes = check_routes("serving", counts, len(modes) * 70 * STEPS,
                          len(modes) * NUM_FRAMES)
    # mode both's first UNet output (after base's STEPS calls), latents
    # and frames: the frame-parallel run's reference; content's frames,
    # the comparison tool's
    return routes, {"unet": unet_outs[STEPS],
                    "latents": report["both"]["latents"],
                    "frames": outs["both"], "content": outs["content"]}


def image_argv(artifacts, device="cuda"):
    """The image path's arguments: mode both with distinct content and
    style prompts, 1024^2, CFG 5, IMAGE_STEPS DPM-Solver++ steps, seed
    0."""
    return ["--prompt", "a dog in watercolor style", "--prompt_content",
            "a dog", "--prompt_style", "watercolor style", "--mode", "both",
            "--unziplora_name_or_path", artifacts, "--resolution",
            str(RESOLUTION), "--guidance_scale", "5", "--sampler", "dpm",
            "--num_inference_steps", str(IMAGE_STEPS), "--seeds", "0",
            "--device", device]


def image_path(artifacts):
    """The image path at full SDXL width: mode both with distinct content
    and style prompts, so 10 of 12 projections per block fold and the
    cross-attention k/v keep live LoRA branches, cached once. Returns
    (launch counts by route, the image and its latents)."""
    from video_style_transfer_tpu_torch.cli import infer

    args = infer.build_parser().parse_args(image_argv(artifacts))
    report = {}
    reset_counters()
    t0 = time.perf_counter()
    outs = infer.generate(args, report)
    total = time.perf_counter() - t0
    counts = counters()
    (name, img), = outs.items()
    rep = report["images"][name]
    print(f"image path: weight init and LoRA import "
          f"{report['weight_init_s']:.3f} s, fold and text encode "
          f"{report['text_encode_s']:.3f} s ({report['n_folded']} "
          f"projections folded), denoise steps "
          f"{', '.join(f'{t:.3f}' for t in rep['denoise_step_s'])} s (step 1 "
          f"includes the cross-attention k/v precompute with live LoRA), "
          f"decode {rep['decode_s']:.3f} s, total {total:.3f} s, peak "
          f"memory {report['peak_memory_gib']:.2f} GiB", flush=True)
    # 70 blocks: attn1 q, k, v, out and attn2 q, out fold; attn2 k, v stay
    if report["n_folded"] != 70 * 6:
        fail(f"the image path folded {report['n_folded']} projections, "
             f"expected {70 * 6}")
    check_counts("image", counts,
                 {**serving_launches(0, 0),
                  "flash_attention_fwd": 70 * IMAGE_STEPS + 1,
                  "geglu_projection": 70 * IMAGE_STEPS})
    shape = (RESOLUTION, RESOLUTION, 3)
    if img.shape != shape or str(img.dtype) != "uint8":
        fail(f"image {img.shape} {img.dtype}, expected {shape} uint8")
    if float(img.std()) == 0.0:
        fail("the image is constant")
    print(f"image: {img.shape} uint8, finite before the cast, mean "
          f"{float(img.mean()):.2f} std {float(img.std()):.2f}", flush=True)
    return (check_routes("image", counts, 70 * IMAGE_STEPS, 1),
            {"image": img, "latents": rep["latents"]})


def vae_bf16_decode_path():
    """The bf16 VAE decode that ``--vae_dtype bfloat16`` gives
    (``pipelines.video.decode_video(..., dtype=torch.bfloat16,
    check_finite=True)``, as ``cli.infer_video`` calls it) on 16 seeded
    latent frames at 1024^2, through the full-width SDXL decoder with
    seeded weights: every frame's mid-block attention on the wide wgmma
    kernel, and the frames within the limits of the JAX package's
    ``tests/test_pipelines.py::test_decode_bf16_close_to_fp32`` (mean
    |diff| < 3, p99 < 16 uint8 levels) of the fp32 decode of the same
    latents. Returns the path's launch counts."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.cli.common import model_configs
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.vae import init_vae_decoder
    from video_style_transfer_tpu_torch.pipelines.video import decode_video

    vcfg = model_configs(smoke=False, motion=True)[1]
    lat = RESOLUTION // 8
    with torch.inference_mode():
        vae = init_vae_decoder(Init(1, "cuda"), vcfg)
        gen = torch.Generator(device="cuda").manual_seed(5)
        z = torch.randn(NUM_FRAMES, lat, lat, vcfg.latent_channels,
                        generator=gen, device="cuda")
        seconds = {}
        frames = {}
        for name, dtype in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            if name == "bf16":
                reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames[name] = decode_video(vae, vcfg, z, chunk=1, dtype=dtype,
                                        check_finite=True).cpu().numpy()
            seconds[name] = time.perf_counter() - t0
            if name == "bf16":
                counts = counters()
                routes = check_routes("bf16 decode", counts, 0, 0,
                                      wide=NUM_FRAMES)
    check_counts("bf16 decode", counts,
                 {**serving_launches(0, 0),
                  "flash_attention_fwd": NUM_FRAMES})
    diff = np.abs(frames["bf16"].astype(np.int32)
                  - frames["fp32"].astype(np.int32))
    mean, p99 = float(diff.mean()), float(np.percentile(diff, 99))
    shape = (NUM_FRAMES, RESOLUTION, RESOLUTION, 3)
    print(f"bf16 decode path: {NUM_FRAMES} frames {shape[1]}x{shape[2]} "
          f"in {seconds['bf16']:.3f} s ({seconds['bf16'] / NUM_FRAMES:.4f} "
          f"s a frame, the VAE's cast included), fp32 "
          f"{seconds['fp32']:.3f} s ({seconds['fp32'] / NUM_FRAMES:.4f} s a "
          f"frame); bf16 vs fp32 pixels: mean |diff| {mean:.4f} (limit 3), "
          f"p99 {p99:.1f} (limit 16), max {int(diff.max())}; frames mean "
          f"{float(frames['bf16'].mean()):.2f} std "
          f"{float(frames['bf16'].std()):.2f}", flush=True)
    for name, video in frames.items():
        if video.shape != shape or str(video.dtype) != "uint8":
            fail(f"{name} decode: frames {video.shape} {video.dtype}, "
                 f"expected {shape} uint8")
        if float(video.std()) == 0.0:
            fail(f"{name} decode: frames are constant")
    if not (mean < 3.0 and p99 < 16):
        fail(f"the bf16 decode is {mean:.3f} mean / {p99:.1f} p99 levels "
             f"from the fp32 decode (limits 3 / 16)")
    return {**routes, "decode_s_per_frame": {
        k: v / NUM_FRAMES for k, v in seconds.items()}}


# the VAE gradient path: gradients through the full-width SDXL VAE at one
# 1024^2 frame with its mid-block attention on K1 + K4 against the same
# call with that attention on the plain route (torch's own ops under
# autograd), same weights, inputs and cotangent; normwise distances of the
# input's gradient and of the mid attention's four projection weights'
# gradients. fp32: both routes are f32 throughout and differ in the order
# of the attention's sums and in K4's 3xTF32 products (~2^-21 each), and
# the decoder's 30-odd layers carry that to the input: 1e-4, the fp32
# limit of the multi-process section's twins. bf16: both round the whole
# VAE at every layer, and the two attentions round P and the output at
# different points (K1/K4 once in f32, the plain route's softmax weights
# to bf16), so the gradients differ by bf16 noise carried through the
# decoder: 2^-4, against which zeroed gradients read 1 and negated ones 2.
VAE_GRAD_LIMITS = {"float32": 1e-4, "bfloat16": 2 ** -4}


@contextlib.contextmanager
def plain_attention():
    """Every fused self-attention of the port on the plain route (the
    reference of the VAE gradient path)."""
    from video_style_transfer_tpu_torch.models import attention as mattn
    from video_style_transfer_tpu_torch.ops import attention as oattn
    real = mattn.sdpa_fused_qkv
    mattn.sdpa_fused_qkv = lambda qkv, heads: oattn.sdpa_fused_qkv(
        qkv, heads, impl="plain")
    try:
        yield
    finally:
        mattn.sdpa_fused_qkv = real


def vae_grad_path():
    """Gradients through the port's ``vae_decode`` (fp32, the default
    --vae_dtype, and bf16) and ``vae_encode`` (fp32) at one 1024^2 frame
    of the full-width SDXL VAE with seeded weights: the input's gradient
    (the latents', or the image's) and the mid-block attention's q, k, v
    and out projection weights', from a seeded cotangent. The mid
    attention (one head, d = 512, 16384 tokens) runs K1 forward and K4
    backward once a call on its sliced route; each call's launches are
    counted by route (check_routes) and its gradients held to
    VAE_GRAD_LIMITS against the plain attention's. Returns the path's
    launch counts, summed over the three calls, and its readings."""
    import torch
    from video_style_transfer_tpu_torch.cli.common import model_configs
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.vae import (
        init_vae_decoder, init_vae_encoder, vae_decode, vae_encode)
    from video_style_transfer_tpu_torch.utils.convert import to_device

    vcfg = model_configs(smoke=False, motion=True)[1]
    lat = RESOLUTION // 8
    gen = torch.Generator(device="cuda").manual_seed(9)
    z = torch.randn(1, lat, lat, vcfg.latent_channels, generator=gen,
                    device="cuda")
    img = torch.rand(1, RESOLUTION, RESOLUTION, 3, generator=gen,
                     device="cuda") * 2 - 1
    trees = {"decode": init_vae_decoder(Init(1, "cuda"), vcfg),
             "encode": init_vae_encoder(Init(3, "cuda"), vcfg)}
    total, readings = None, {}
    for side, name, route in (("decode", "float32", "tf32x3_sliced"),
                              ("decode", "bfloat16", "wgmma_sliced"),
                              ("encode", "float32", "tf32x3_sliced")):
        dt = getattr(torch, name)
        params = trees[side] if dt == torch.float32 else to_device(
            trees[side], dtype=dt)
        fn = vae_decode if side == "decode" else vae_encode
        attn = params["decoder" if side == "decode" else "encoder"][
            "mid_block"]["attentions"][0]
        weights = {n: attn[n]["weight"].requires_grad_()
                   for n in ("to_q", "to_k", "to_v", "to_out")}
        x = (z if side == "decode" else img).to(dt)

        def run():
            xx = x.clone().requires_grad_()
            for w in weights.values():
                w.grad = None
            y = fn(params, vcfg, xx)
            cot = torch.randn(y.shape, device="cuda",
                              generator=torch.Generator(
                                  device="cuda").manual_seed(10)).to(dt)
            y.backward(cot)
            torch.cuda.synchronize()
            return {"input": xx.grad,
                    **{n: w.grad for n, w in weights.items()}}, y.shape

        run()  # warm-up: the cuDNN plans of the backward's convolutions
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got, shape = run()
        seconds = time.perf_counter() - t0
        counts = counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        label = f"vae {side} grad {name}"
        routes = check_routes(
            label, counts, 0, 0 if dt == torch.bfloat16 else 1,
            wide=1 if dt == torch.bfloat16 else 0,
            bwd_wgmma_sliced=int(route == "wgmma_sliced"),
            bwd_tf32x3_sliced=int(route == "tf32x3_sliced"))
        check_counts(label, counts, {**serving_launches(0, 0),
                                     "flash_attention_fwd": 1,
                                     "flash_attention_bwd": 1,
                                     "flash_attention_bwd_delta": 1})
        with plain_attention():
            t1 = time.perf_counter()
            want, _ = run()
            plain_seconds = time.perf_counter() - t1
        for w in weights.values():
            w.requires_grad_(False)
            w.grad = None
        errs = {}
        for key, g in got.items():
            r = want[key].double()
            errs[key] = ((g.double() - r).norm() / r.norm()).item()
            if not bool(torch.isfinite(g.float()).all()):
                fail(f"{label}: non-finite gradient of {key}")
        worst = max(errs.values())
        limit = VAE_GRAD_LIMITS[name]
        print(f"{label} ({tuple(x.shape)} -> {tuple(shape)}): forward and "
              f"backward {seconds:.3f} s (plain attention {plain_seconds:.3f}"
              f" s), peak memory {peak:.2f} GiB; gradients against the "
              f"plain attention's, normwise: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (limit {limit:g})", flush=True)
        if worst > limit:
            fail(f"{label}: gradients {worst:.3e} from the plain attention's "
                 f"(limit {limit:g})")
        readings[f"{side}_{name}"] = {"seconds": seconds,
                                      "plain_attention_seconds":
                                          plain_seconds,
                                      "peak_memory_gib": peak,
                                      "normwise": errs, "limit": limit}
        total = routes if total is None else {
            k: (total[k] + v if isinstance(v, int) else
                {r: total[k][r] + n for r, n in v.items()})
            for k, v in routes.items()}
        del got, want, params, attn, weights
        torch.cuda.empty_cache()
    return {**total, "readings": readings}


# the native clip preprocessing: a seeded 1080p BGR clip to 1024^2, native
# against the plain numpy version (data/native.py), as the JAX package's
# tests/test_native.py holds them: the resize within one level, the
# output within 0.01
NATIVE_CLIP = (16, 1080, 1920, 3)
NATIVE_LIMITS = (1, 0.01)
# LPIPS (models/lpips.py, cuDNN convolutions) with seeded full-VGG16
# weights, card against CPU in fp32 at one 256^2 pair, within the JAX
# package's LPIPS tolerance (rtol 1e-4, atol 1e-5)
LPIPS_TOL = (1e-4, 1e-5)
LPIPS_RES = 256
# the parity runbook on the synthetic checkpoint: the card's images
# against the CPU run's (the reference outputs), PSNR at least this
RUNBOOK_PSNR_MIN = 40.0


def native_phase():
    """The native preprocessing library built from the checkout, held
    against its plain version on a seeded 1080p clip and timed (best of
    three; the plain version once); the cv2 chain's time beside."""
    import numpy as np
    from video_style_transfer_tpu_torch.data import native

    t0 = time.perf_counter()
    if not native.native_available():
        fail("the native preprocessing library is not available (the "
             "compiler's log is above)")
    build_s = time.perf_counter() - t0
    clip = np.random.default_rng(41).integers(0, 256, NATIVE_CLIP,
                                              dtype=np.uint8)
    res = RESOLUTION
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = native.preprocess_frames_bgr(clip, res, res)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = native.preprocess_frames_bgr_plain(clip, res, res)
    plain_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    levels = int(np.abs(native.resize_bilinear(clip[0], res, res).astype(int)
                        - native.resize_bilinear_plain(clip[0], res, res)
                        .astype(int)).max())
    cv2_s = None
    try:
        import cv2
        t0 = time.perf_counter()
        for f in clip:
            cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2RGB), (res, res),
                       interpolation=cv2.INTER_LINEAR).astype(
                np.float32) / 127.5 - 1.0
        cv2_s = time.perf_counter() - t0
    except ImportError:
        pass
    openmp = native.build_info["openmp"]
    out = {"native_s": min(times), "plain_s": plain_s, "cv2_s": cv2_s,
           "load_s": build_s, "max_abs_err": err, "resize_levels": levels,
           "clip": list(NATIVE_CLIP), "to": res, "openmp": openmp,
           "host_cores": os.cpu_count()}
    print(f"native preprocessing ({NATIVE_CLIP} uint8 BGR -> {res}^2, "
          f"{os.cpu_count()} host cores, "
          f"{'OpenMP' if openmp else 'built without OpenMP, a thread a share of the frames'}"
          f"; library built and loaded in "
          f"{build_s:.2f} s): native {min(times):.3f} s (best of 3), plain "
          f"numpy {plain_s:.3f} s, cv2 chain "
          f"{'n/a' if cv2_s is None else f'{cv2_s:.3f} s'}; output "
          f"{err:.3e} from the plain version (limit {NATIVE_LIMITS[1]}), "
          f"the resize {levels} level(s) (limit {NATIVE_LIMITS[0]})",
          flush=True)
    if got.shape != (NATIVE_CLIP[0], res, res, 3) or \
            not np.isfinite(got).all():
        fail(f"native preprocessing gave {got.shape}")
    if levels > NATIVE_LIMITS[0] or err > NATIVE_LIMITS[1]:
        fail(f"native preprocessing {levels} levels / {err:.3e} from its "
             f"plain version")
    return out


def lpips_state_dict(params):
    """models/lpips.py params -> the torchvision + lpips names."""
    from video_style_transfer_tpu_torch.models.lpips import (
        VGG16_SLICE_CONV_IDX)
    sd = {}
    for convs, idxs, lin, s in zip(params["slices"], VGG16_SLICE_CONV_IDX,
                                   params["lins"], range(5)):
        for conv, i in zip(convs, idxs):
            sd[f"features.{i}.weight"] = conv["weight"]
            sd[f"features.{i}.bias"] = conv["bias"]
        sd[f"lin{s}.model.1.weight"] = lin["weight"].reshape(
            1, -1, 1, 1).contiguous()
    return sd


def lpips_phase(tmp, serving_ref):
    """LPIPS with seeded full-VGG16 weights read back from a safetensors
    file: card against CPU at one 256^2 pair (fp32, TF32 off), then
    cli.compare_outputs' measures (PSNR, SSIM, per-frame LPIPS on the
    card) on the serving path's 16 mode-both frames against its content
    frames at 1024^2, timed. Returns (the weights file, readings)."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.cli import compare_outputs
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.lpips import (
        init_lpips, lpips_distance)
    from video_style_transfer_tpu_torch.utils.safetensors_io import save_file

    path = os.path.join(tmp, "lpips_seeded.safetensors")
    save_file(lpips_state_dict(init_lpips(Init(5))), path)
    cpu = compare_outputs.load_lpips_weights(path, "cpu")
    card = compare_outputs.load_lpips_weights(path, "cuda")
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((1, LPIPS_RES, LPIPS_RES, 3), generator=gen) * 2 - 1
    y = (x + 0.2 * torch.randn(x.shape, generator=gen)).clamp(-1, 1)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = lpips_distance(cpu, x, y)
        cpu_s = time.perf_counter() - t0
        xc, yc = x.cuda(), y.cuda()
        got = lpips_distance(card, xc, yc)
        ms = time_ms(lambda: lpips_distance(card, xc, yc), 10)
    d_cpu, d_card = float(want[0]), float(got[0])
    err = abs(d_card - d_cpu)
    rtol, atol = LPIPS_TOL
    print(f"LPIPS (seeded VGG16 weights, {LPIPS_RES}^2 pair, fp32): card "
          f"{d_card:.7f}, CPU {d_cpu:.7f}, {err:.3e} apart (limit {atol:g} "
          f"+ {rtol:g}*|CPU|); card {ms:.3f} ms a pair, CPU "
          f"{1e3 * cpu_s:.1f} ms", flush=True)
    if not err <= atol + rtol * abs(d_cpu) or d_cpu <= 0:
        fail(f"LPIPS on the card {d_card} against the CPU's {d_cpu}")
    a, b = serving_ref["frames"], serving_ref["content"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals = compare_outputs.lpips_frames(card, a, b, torch.device("cuda"))
    lpips_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    psnrs = [compare_outputs.psnr(f, g) for f, g in zip(a, b)]
    ssims = [compare_outputs.ssim(f, g) for f, g in zip(a, b)]
    host_s = time.perf_counter() - t0
    print(f"compare_outputs, serving's {len(a)} mode-both frames against "
          f"its content frames at {a.shape[1]}^2: LPIPS mean "
          f"{float(np.mean(vals)):.4f} max {float(np.max(vals)):.4f} "
          f"({lpips_s:.2f} s on the card, {1e3 * lpips_s / len(a):.1f} ms a "
          f"frame), PSNR mean {float(np.mean(psnrs)):.2f} dB, SSIM mean "
          f"{float(np.mean(ssims)):.4f} ({host_s:.2f} s on the host)",
          flush=True)
    if not np.isfinite(vals).all() or len(vals) != len(a):
        fail(f"compare_outputs LPIPS gave {vals}")
    return path, {"pair": {"card": d_card, "cpu": d_cpu, "abs_err": err,
                           "card_ms": ms, "cpu_s": cpu_s},
                  "compare": {"frames": len(a), "lpips_s": lpips_s,
                              "psnr_ssim_s": host_s,
                              "lpips_mean": float(np.mean(vals)),
                              "psnr_mean": float(np.mean(psnrs)),
                              "ssim_mean": float(np.mean(ssims))}}


def runbook_phase(tmp, lpips_path):
    """cli.verify_parity --config_preset tiny on the synthetic checkpoint:
    its CPU run up to the generate stage gives the reference outputs, then
    the card runs all four stages against them (the seeded LPIPS weights
    and a PSNR gate) and must exit 0."""
    from video_style_transfer_tpu_torch.cli import verify_parity

    ckpt = verify_parity.make_synthetic_checkpoint(
        os.path.join(tmp, "synthetic_ckpt"))
    run = ["--pretrained_model_name_or_path", ckpt, "--config_preset",
           "tiny", "--prompt", "a photo of a dog", "--num_inference_steps",
           "2", "--resolution", "16", "--seeds", "0", "1"]
    ref = os.path.join(tmp, "runbook_cpu")
    t0 = time.perf_counter()
    rc = verify_parity.main(run + [
        "--device", "cpu", "--stop_after", "generate", "--output_dir", ref,
        "--report", os.path.join(tmp, "runbook_cpu.json")])
    cpu_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"the runbook's CPU run exited {rc}")
    report_path = os.path.join(tmp, "runbook_card.json")
    t0 = time.perf_counter()
    rc = verify_parity.main(run + [
        "--device", "cuda", "--reference_outputs", ref, "--lpips",
        lpips_path, "--psnr_min", str(RUNBOOK_PSNR_MIN), "--output_dir",
        os.path.join(tmp, "runbook_card"), "--report", report_path])
    card_s = time.perf_counter() - t0
    with open(report_path) as f:
        report = json.load(f)
    pairs = report["stages"].get("compare", {}).get("pairs", [])
    print(f"runbook (verify_parity, tiny synthetic checkpoint): CPU run "
          f"{cpu_s:.1f} s, card run {card_s:.1f} s through stages "
          f"{list(report['stages'])}, exit {rc}; card against CPU: "
          + ", ".join(f"{os.path.basename(p['ours'])} PSNR "
                      f"{p.get('psnr_mean', 0):.2f} dB LPIPS max "
                      f"{p.get('lpips_max', float('nan')):.2e}"
                      for p in pairs), flush=True)
    if rc != 0 or list(report["stages"]) != ["inventory", "load",
                                             "generate", "compare"]:
        fail(f"the runbook on the card exited {rc}: {report}")
    return {"cpu_s": cpu_s, "card_s": card_s, "exit": rc,
            "pairs": [{k: p[k] for k in ("psnr_mean", "ssim_mean",
                                         "lpips_max", "psnr_gate",
                                         "lpips_gate")} for p in pairs]}


def ptxas_report(log, pattern):
    """Registers, spills and wgmma serialisation of the kernels whose
    mangled name matches `pattern` (its first group names the entry), from
    nvcc's -Xptxas -v report. ``wgmma_serialized`` is None, or the reason
    ptxas gave for issuing the kernel's wgmma.mma_async one at a time
    ("Potential Performance Loss: wgmma.mma_async instructions are
    serialized due to ... in the function '...'")."""
    import re
    out, key = {}, None
    for ln in log:
        if "Compiling entry function" in ln:
            m = re.search(pattern, ln)
            key = m.group(1) if m else None
            if key is not None:
                out.setdefault(key, {}).setdefault("wgmma_serialized", None)
            continue
        if "wgmma" in ln and "serializ" in ln:
            named = re.search(r"function '([^']+)'", ln)
            m = re.search(pattern, named.group(1)) if named else None
            target = m.group(1) if m else None if named else key
            if target is not None:
                why = re.search(r"serialized due to (.*?)(?: in the "
                                r"function|$)", ln)
                out.setdefault(target, {})["wgmma_serialized"] = (
                    why.group(1).strip() if why else ln.strip())
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(key, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def sm90_ptxas(log):
    """Registers, spills and wgmma serialisation of the wgmma route's
    kernels, by head dim (d = 64: the persistent kernel; 128-256: the
    template's instances; 320-512: the wide kernel's). ptxas gives the
    count a thread holds at launch (d = 64: 512 threads, at most 128 each,
    then setmaxnreg moves the producer warpgroup to 32 and the three
    consumer warpgroups to 160; d >= 128: 384 threads, at most 168, then
    40 and 232). Fails if one spills or has its products serialised: the
    d = 64 kernel overlaps its softmax with wgmma groups in flight, and
    every one keeps its accumulators in registers."""
    rep = ptxas_report(log, r"(flash_fwd_sm90_d64_kernel|"
                            r"flash_fwd_sm90_kernelILi\d+E|"
                            r"flash_fwd_sm90_wide_kernelILi\d+E)")
    out = {("64" if name.endswith("d64_kernel")
            else name.rsplit("ILi", 1)[1][:-1]): r for name, r in rep.items()}
    if sorted(out, key=int) != [str(d) for d in (64, 128, 192, 256, 320,
                                                 384, 448, 512)]:
        fail(f"the build log names no wgmma kernel for every head dim: "
             f"{sorted(out)}")
    for d, r in out.items():
        if r.get("spill_stores", 1) or r.get("spill_loads", 1):
            fail(f"K1's wgmma kernel at d = {d} spills registers: {r}")
        if r["wgmma_serialized"]:
            fail(f"ptxas serialised the wgmma products of K1's kernel at "
                 f"d = {d}: {r['wgmma_serialized']}")
    print(f"K1 wgmma kernels (ptxas): {json.dumps(out)}", flush=True)
    return out


def bwd_ptxas(log):
    """Registers and spills of K4's bf16 kernels (the wgmma dk/dv and dq
    kernels, 384 threads, setmaxnreg as K1's; the delta kernel). Fails if
    one spills: their accumulators live in registers by design."""
    out = ptxas_report(log, r"(flash_bwd_dkv_sm90_kernel|"
                            r"flash_bwd_dq_sm90_kernel|"
                            r"flash_bwd_delta_kernelI13__nv_bfloat16)")
    want = ["flash_bwd_delta_kernelI13__nv_bfloat16",
            "flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel"]
    if sorted(out) != want:
        fail(f"the build log names no K4 bf16 kernels: {sorted(out)}")
    for name, rep in out.items():
        if rep.get("spill_stores", 1) or rep.get("spill_loads", 1):
            fail(f"K4's {name} spills registers: {rep}")
    print(f"K4 bf16 kernels (ptxas; wgmma_serialized is reported, not "
          f"held): {json.dumps(out)}", flush=True)
    return out


def sliced_ptxas(log):
    """Registers, spills and wgmma serialisation of K4's kernels at d =
    128-512: the bf16 dk/dv and dq kernels by head dim (a template on D /
    64 panels; 384 threads, 168 registers at launch, then setmaxnreg moves
    the producer warpgroup to 24 and the two consumer warpgroups to 240)
    and the fp32 ones (a template on D; 256 threads, at most 255
    registers a thread). Fails if one spills, or if ptxas serialised a
    bf16 kernel's products."""
    rep = ptxas_report(log, r"(flash_bwd_sliced_sm90_kernelILb[01]ELi\d+E|"
                            r"flash_bwd_split_tf32_kernelILb[01]ELi\d+E)")
    out = {"bf16": {}, "fp32": {}}
    for name, r in rep.items():
        kern = "dq" if "ILb1E" in name else "dkv"
        n = int(name.rsplit("Li", 1)[1][:-1])
        if "sm90" in name:
            out["bf16"][f"{kern} d{64 * n}"] = r
        else:
            out["fp32"][f"{kern} d{n}"] = r
    want = sorted(f"{k} d{d}" for k in ("dkv", "dq")
                  for d in (128, 192, 256, 320, 384, 448, 512))
    if sorted(out["bf16"]) != want or sorted(out["fp32"]) != want:
        fail(f"the build log names no sliced K4 kernel for every head "
             f"dim: {sorted(out['bf16'])}, {sorted(out['fp32'])}")
    for dt, kernels in out.items():
        for key, r in kernels.items():
            if r.get("spill_stores", 1) or r.get("spill_loads", 1):
                fail(f"K4's {dt} sliced {key} kernel spills registers: {r}")
            if dt == "bf16" and r["wgmma_serialized"]:
                fail(f"ptxas serialised the wgmma products of K4's sliced "
                     f"{key} kernel: {r['wgmma_serialized']}")
    print(f"K4 sliced kernels (ptxas): {json.dumps(out)}", flush=True)
    return out


def geglu_ptxas(log):
    """Registers, spills and wgmma serialisation of K2's kernels, by dtype
    and gate (384 threads, at most 168 registers each at launch, then
    setmaxnreg moves the producer warpgroup to 40 and the two consumer
    warpgroups to 232), and of the fp32 route's W split. Fails if one
    spills or has its products serialised: each bf16 consumer keeps a K
    slice's products in flight while it waits for the next stage, each
    fp32 one a restart's six, which serialisation would undo."""
    rep = ptxas_report(log, r"(geglu_(?:bf16|f32)_kernelILi\d+E|"
                            r"geglu_split_w_kernel)")
    gates = {"0": "erf5", "1": "cdf3", "2": "poly14"}
    out = {}
    for name, r in rep.items():
        if name == "geglu_split_w_kernel":
            out["fp32 W split"] = r
        else:
            dt = "bf16" if "bf16" in name else "fp32"
            out[f"{dt} {gates[name.rsplit('ILi', 1)[1][:-1]]}"] = r
    want = sorted([f"{dt} {g}" for dt in ("bf16", "fp32")
                   for g in gates.values()] + ["fp32 W split"])
    if sorted(out) != want:
        fail(f"the build log names no K2 kernel for every dtype and gate: "
             f"{sorted(out)}")
    for key, r in out.items():
        if r.get("spill_stores", 1) or r.get("spill_loads", 1):
            fail(f"K2's {key} kernel spills registers: {r}")
        if r["wgmma_serialized"]:
            fail(f"ptxas serialised the wgmma products of K2's {key} "
                 f"kernel: {r['wgmma_serialized']}")
    print(f"K2 kernels (ptxas): {json.dumps(out)}", flush=True)
    return out


def tf32_ptxas(log):
    """Registers and spills of the 3xTF32 route's kernels (K1's fp32 d =
    64 forward, K4's fp32 dk/dv and dq; 128 threads, two blocks an SM, so
    at most 255 registers each). Fails if one spills or the build log
    names none of them: their accumulators and S, P, dP, dS live in
    registers by design."""
    out = ptxas_report(log, r"(flash_fwd_tf32_kernel|"
                            r"flash_bwd_dkv_tf32_kernel|"
                            r"flash_bwd_dq_tf32_kernel)")
    want = ["flash_bwd_dkv_tf32_kernel", "flash_bwd_dq_tf32_kernel",
            "flash_fwd_tf32_kernel"]
    if sorted(out) != want:
        fail(f"the build log names no 3xTF32 kernels: {sorted(out)}")
    for name, rep in out.items():
        if rep.get("spill_stores", 1) or rep.get("spill_loads", 1):
            fail(f"the 3xTF32 route's {name} spills registers: {rep}")
    print(f"3xTF32 kernels (ptxas): {json.dumps(out)}", flush=True)
    return out


def _ta_ptxas(log, kernel, label, frame_bounds):
    """Registers and spills of a temporal attention kernel's instances
    (`kernel`: K3's or K5's), by dtype and frame bound (8 F / 8 frames at
    most, F its n tiles of S). Fails if one spills or the build log names
    one short of every dtype at `frame_bounds`."""
    rep = ptxas_report(log,
                       rf"({kernel}I(?:f|13__nv_bfloat16)Li\dE)")
    out = {}
    for name, r in rep.items():
        dt = "float32" if "kernelIf" in name else "bfloat16"
        out[f"{dt} F<={8 * int(name[-2])}"] = r
    want = sorted(f"{dt} F<={f}" for dt in ("bfloat16", "float32")
                  for f in frame_bounds)
    if sorted(out) != want:
        fail(f"the build log names no {label} kernel for every dtype and "
             f"frame count: {sorted(out)}")
    for key, r in out.items():
        if r.get("spill_stores", 1) or r.get("spill_loads", 1):
            fail(f"{label}'s {key} kernel spills registers: {r}")
    print(f"{label} kernels (ptxas): {json.dumps(out)}", flush=True)
    return out


def ta_ptxas(log):
    """K3's tensor-core forward (288 threads, one block an SM, so at most
    168 registers each: three of its nine warps share one of the SM's
    four register files): S, P and O's column chunk live in registers by
    design."""
    return _ta_ptxas(log, "ta_fwd_mma_kernel", "K3", (8, 16, 24, 32))


def ta_bwd_ptxas(log):
    """K5's tensor-core backward (two n tiles of S at least, since clips
    of F <= 8 frames pack 16 / F pairs into one 16-row tile; one block an
    SM, of sixteen warps up to 16 frames, so at most 128 registers each,
    and of eight past 16, at most 255): S, dP, w, ds and an output's
    column chunk live in registers by design."""
    return _ta_ptxas(log, "ta_bwd_mma_kernel", "K5", (16, 24, 32))


def fma_ptxas(log):
    """Registers and spills of the FMA route's kernel at each head dim
    (256 threads, up to 255 registers each, one block an SM) and of the
    kv-split combine it shares with the wide wgmma kernel (fp32 and bf16
    out). Fails if an FMA instance spills: its O tile lives in registers
    by design."""
    rep = ptxas_report(
        log, r"(flash_fwd_f32_kernelILi\d+E|"
             r"flash_combine_kernelI(?:f|13__nv_bfloat16)E)")
    out = {}
    for name, r in rep.items():
        out[f"d{name.rsplit('ILi', 1)[1][:-1]}" if "f32_kernel" in name
            else name] = r
    want = sorted(["flash_combine_kernelI13__nv_bfloat16E",
                   "flash_combine_kernelIfE",
                   *(f"d{d}" for d in (128, 192, 256, 320, 384, 448, 512))])
    if sorted(out) != want:
        fail(f"the build log names no FMA-route kernel for every head dim: "
             f"{sorted(out)}")
    for key, r in out.items():
        if key.startswith("d") and (r.get("spill_stores", 1)
                                    or r.get("spill_loads", 1)):
            fail(f"the FMA route's kernel at {key} spills registers: {r}")
    print(f"FMA-route kernels (ptxas): {json.dumps(out)}", flush=True)
    return out


# -------------------------------------------------------------- multi-process
# Two processes on the one card, each joining a gloo process group that
# this script sets up (NCCL refuses two ranks on one device), driving the
# CLIs' data- and frame-parallel paths through their normal entry points.
# Times are those of two ranks time-sharing one card, not a multi-GPU
# speed.
MP_WORLD = 2
# stage 2 at 512^2 (SDXL's widths, 8 frames): the two processes' peaks
# together must stay under the card's 80 GB (one process at 1024^2 peaks
# at 57 GiB); a seeded 8-frame video in memory, one clip start
MP_TRAIN_RES, MP_TRAIN_STEPS = 512, 2
# the fp32 twins (serving and stage 2 under --mixed_precision no, the
# gates of the two-process paths) take one step each; stage 2's without
# warmup, so that its one update is not zero
MP_FP32_STEPS = 1
# stage 1: 2 steps of the column separation at one sample time (phases
# reset, select), batch 2 (one row a process); the selection is step 1
MP_STAGE1_STEPS, MP_STAGE1_SELECT = 2, 1
# limits of the two-process runs against one process. fp32 (serving and
# stage 2): the first UNet output, the latents, the losses, the
# per-tensor gradient norms and the tensors after the step within the
# port's model tolerance against JAX (1e-4, normwise). bf16: two bf16 runs
# that round differently (GEMMs over other row counts) are two draws of
# bf16's own error, so their distances are readings; the served frames
# are held to the bf16 decode phase's uint8 levels. Stage 1 (bf16, no
# fp32 twin): per-tensor gradient norms and the LoRA leaves normwise, the
# losses relatively, and the masks the selection of the world's summed
# gradients
MP_FP32_NORMWISE = 1e-4
MP_FRAME_LEVELS = (3.0, 16.0)
MP_GRAD_NORMWISE = 2 ** -5
MP_TENSOR_NORMWISE = 2 ** -8
MP_LOSS_REL = 2 ** -6
MP_TIMEOUT_S = 900
# what rank 0 captures at the stage-1 selection step: each projection's
# LoRA tensors, summed gradients and state, for one process to select from
MP_SELECT_FILE = "stage1_select.pt"


@contextlib.contextmanager
def kept_unet_outputs(store):
    """While open, every UNet call the pipelines make (through
    pipelines.sampling) appends its output, fp32 on the CPU, to
    `store`."""
    from video_style_transfer_tpu_torch.pipelines import sampling
    orig = sampling.unet_apply

    def keep(*args, **kw):
        out = orig(*args, **kw)
        store.append(out.float().cpu())
        return out

    sampling.unet_apply = keep
    try:
        yield store
    finally:
        sampling.unet_apply = orig


def mp_probe(rank):
    """gloo's collectives on CUDA tensors of two ranks on one card:
    all_to_all_single, all_reduce, all_gather (uint8) and a barrier."""
    import torch
    import torch.distributed as dist
    x = torch.arange(8, device="cuda", dtype=torch.float32) + 100 * rank
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    want = torch.cat([torch.arange(4 * rank, 4 * rank + 4,
                                   dtype=torch.float32) + 100 * s
                      for s in range(MP_WORLD)]).cuda()
    z = x.clone()
    dist.all_reduce(z)
    parts = [torch.empty(3, device="cuda", dtype=torch.uint8)
             for _ in range(MP_WORLD)]
    dist.all_gather(parts, torch.full((3,), rank, device="cuda",
                                      dtype=torch.uint8))
    dist.barrier()
    ok = (torch.equal(y, want)
          and torch.equal(z, 2 * torch.arange(8, device="cuda",
                                               dtype=torch.float32) + 100)
          and [int(p[0]) for p in parts] == list(range(MP_WORLD)))
    if not ok:
        fail(f"rank {rank}: gloo collectives on CUDA tensors gave "
             f"{y.tolist()}, {z.tolist()}, {[p.tolist() for p in parts]}")
    # a reading, not used by the package (it sums gradients in float32):
    # gloo's sum of bf16 CUDA tensors against the float32 sum, rounded
    gen = torch.Generator(device="cuda")
    vals = []
    for r in range(MP_WORLD):
        gen.manual_seed(r)
        vals.append(torch.randn(1 << 16, device="cuda", generator=gen)
                    .to(torch.bfloat16))
    got = vals[rank].clone()
    dist.all_reduce(got)
    want = sum(v.float() for v in vals).to(torch.bfloat16)
    bf16_err = float((got.float() - want.float()).abs().max())
    return {"all_to_all_single": True, "all_reduce": True,
            "all_gather": True, "bf16_all_reduce_max_abs_err": bf16_err}


def mp_routes():
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu
    return {"K1": dict(fa.ROUTE_LAUNCHES), "K4": dict(fa.BWD_ROUTE_LAUNCHES),
            "K2": dict(geglu.ROUTE_LAUNCHES)}


def mp_serving_args(rank_flags, fp32=False):
    """The serving phase's arguments; fp32: --mixed_precision no at
    MP_FP32_STEPS steps."""
    return ["--prompt", "a horse galloping through a snowy forest",
            "--content_prompt", "a horse galloping",
            "--style_prompt", "a snowy forest in watercolor",
            "--num_frames", str(NUM_FRAMES), "--resolution", str(RESOLUTION),
            "--num_inference_steps", str(MP_FP32_STEPS if fp32 else STEPS),
            "--guidance_scale", "7.5", "--seed", "0", "--modes",
            "both"] + rank_flags + (["--mixed_precision", "no"] if fp32
                                    else [])


def mp_serving(cfg, rank, fp32=False):
    """cli.infer_video.generate with --frame_parallel 2: mode both from
    the artifact set and motion checkpoint of the serving phase, in bf16
    or (fp32) with --mixed_precision no at MP_FP32_STEPS steps."""
    import torch
    from video_style_transfer_tpu_torch.cli import infer_video
    from video_style_transfer_tpu_torch.parallel import distributed

    label = f"frame-parallel serving{' fp32' if fp32 else ''} (rank {rank})"
    args = infer_video.build_parser().parse_args(mp_serving_args([
        "--unziplora_name_or_path", cfg["artifacts"], "--motion_checkpoint",
        cfg["motion_checkpoint"], "--frame_parallel", str(MP_WORLD),
        "--device", "cuda:0"], fp32))
    torch.cuda.reset_peak_memory_stats()
    report, unet_outs = {}, []
    reset_counters()
    distributed.EXCHANGED_BYTES = 0
    t0 = time.perf_counter()
    with kept_unet_outputs(unet_outs):
        outs = infer_video.generate(args, report)
    total = time.perf_counter() - t0
    counts = counters()
    frames = NUM_FRAMES // MP_WORLD
    steps = MP_FP32_STEPS if fp32 else STEPS
    check_counts(label, counts, serving_launches(steps, frames))
    # fp32: every UNet attention and feed-forward on the 3xTF32 routes
    calls = 70 * steps
    routes = check_routes(label, counts, 0 if fp32 else calls, frames,
                          tf32x3=calls if fp32 else 0,
                          geglu_tf32x3=85 * steps if fp32 else 0)
    rep = report["both"]
    a, b = rep["frame_range"]
    return {"s": total, "weight_init_s": report["weight_init_s"],
            "denoise_step_s": rep["denoise_step_s"],
            "decode_s": rep["decode_s"], "frame_range": (a, b),
            "unet": unet_outs[0], "latents": rep["latents"],
            "frames": outs["both"][a:b],
            "shape": tuple(outs["both"].shape), "launches": routes,
            "exchanged_bytes": distributed.EXCHANGED_BYTES,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def mp_video():
    import numpy as np
    return np.random.default_rng(31).integers(
        0, 256, (TRAIN_FRAMES, MP_TRAIN_RES, MP_TRAIN_RES, 3), dtype=np.uint8)


def mp_grad_norms(store):
    """on_grads hook keeping each step's per-tensor gradient norms."""
    import torch

    def hook(*args):
        grads = args[-1]
        if isinstance(grads, dict):
            grads = list(grads.values())
        store.append(torch.stack([g.float().norm() for g in grads]).cpu())
    return hook


def mp_stage2_args(out_dir, extra, fp32=False):
    """The two-process section's stage-2 arguments: MP_TRAIN_STEPS steps
    with a checkpoint after each and one step of warmup; fp32:
    --mixed_precision no, MP_FP32_STEPS steps, no warmup, no
    checkpoint."""
    if fp32:
        run = ["--lr_warmup_steps", "0", "--checkpointing_steps", "1000",
               "--max_train_steps", str(MP_FP32_STEPS),
               "--mixed_precision", "no"]
    else:
        run = ["--lr_warmup_steps", "1", "--checkpointing_steps", "1",
               "--max_train_steps", str(MP_TRAIN_STEPS)]
    return ["--output_dir", out_dir,
            "--prompt", "a horse galloping through a snowy forest",
            "--num_frames", str(TRAIN_FRAMES), "--resolution",
            str(MP_TRAIN_RES), "--seed", "0", "--log_every", "1"] + run \
        + extra


def mp_stage2_run(out_dir, flags, label, fp32=False, on_setup=None):
    """One cli.train_animatediff.train run of the two-process section's
    configuration (`flags` add the process's own; fp32:
    mp_stage2_args's). Returns (trainer, report, per-step gradient norms,
    launches by route, peak GiB). Its launches must be those of a rank's
    frames (or one process's), by route."""
    import torch
    from video_style_transfer_tpu_torch.cli import train_animatediff
    from video_style_transfer_tpu_torch.cli.common import model_configs

    torch.cuda.reset_peak_memory_stats()
    norms, report = [], {}
    reset_counters()
    tr = train_animatediff.train(
        train_animatediff.build_parser().parse_args(mp_stage2_args(
            out_dir, flags, fp32)),
        report, on_setup, dataset=ArrayClips(mp_video(), TRAIN_FRAMES),
        on_grads=mp_grad_norms(norms))
    counts = counters()
    frames = TRAIN_FRAMES // tr.grid.frame
    encoded = sum(report["encoded_frames"])
    if encoded != frames:
        fail(f"{label} encoded {encoded} frames, expected {frames}")
    want = expected_train_launches(
        model_configs(smoke=False, motion=True)[0], frames=frames,
        resolution=MP_TRAIN_RES,
        steps=MP_FP32_STEPS if fp32 else MP_TRAIN_STEPS, encoded=encoded)
    check_counts(label, counts, {**serving_launches(0, 0), **want})
    flash = want["flash_attention_bwd"]
    # fp32: every UNet attention, its backward and every feed-forward on
    # the 3xTF32 routes
    routes = check_routes(label, counts, 0 if fp32 else flash, encoded,
                          bwd_wgmma=0 if fp32 else flash,
                          tf32x3=flash if fp32 else 0,
                          bwd_tf32x3=flash if fp32 else 0,
                          geglu_tf32x3=(want["geglu_projection"] if fp32
                                        else 0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return tr, report, norms, routes, peak


def mp_stage2(cfg, rank, fp32=False):
    """cli.train_animatediff.train with --frame_parallel 2: 2 steps with a
    checkpoint after each, then (bf16) a run resumed from checkpoint-1
    (restored tensors and optimizer state bitwise the file's) for its
    second step."""
    import torch
    from video_style_transfer_tpu_torch.utils import checkpoint as ckpt

    out_dir = os.path.join(cfg["root"], "stage2_fp32" if fp32 else "stage2")
    flags = ["--frame_parallel", str(MP_WORLD), "--device", "cuda:0",
             "--unziplora_name_or_path", cfg["artifacts"]]
    tr, report, norms, routes, peak = mp_stage2_run(
        out_dir, flags, f"frame-parallel stage-2{' fp32' if fp32 else ''} "
        f"(rank {rank})", fp32)
    tensors = {"/".join(map(str, p)): t.detach().cpu()
               for p, t in tr.trainable}
    del tr
    torch.cuda.empty_cache()
    out = {"loss": report["loss"], "step_s": report["step_s"],
           "encode_s": report["encode_s"],
           "weight_init_s": report["weight_init_s"], "grad_norms": norms,
           "sums": [float(t.double().sum()) for t in tensors.values()],
           "tensors": tensors if rank == 0 and fp32 else None,
           "launches": routes, "peak_gib": peak}
    if fp32:
        return out
    restored = {}
    first = os.path.join(out_dir, "checkpoints", "checkpoint-1")

    def on_setup(tr_b):
        saved = torch.load(os.path.join(first, ckpt.STATE_FILE),
                           map_location="cpu", weights_only=True)
        now = ckpt.train_state(tr_b.trainable, tr_b.optimizer, tr_b.start)
        restored["bitwise"] = (_tree_equal(now["trainable"],
                                           saved["trainable"])
                               and _tree_equal(now["optimizer_state"],
                                               saved["optimizer_state"])
                               and tr_b.start == saved["step"] == 1)

    from video_style_transfer_tpu_torch.cli import train_animatediff
    rep_b = {}
    train_animatediff.train(
        train_animatediff.build_parser().parse_args(mp_stage2_args(
            out_dir, flags + ["--resume_from_checkpoint", first])), rep_b,
        on_setup, dataset=ArrayClips(mp_video(), TRAIN_FRAMES))
    if not restored.get("bitwise"):
        fail(f"stage-2 rank {rank}: the resumed run's state differs from "
             f"checkpoint-1")
    return {**out, "resumed_loss": rep_b["loss"], "resume_bitwise": True}


def mp_stage1_images():
    import numpy as np
    rng = np.random.default_rng(41)
    return rng.integers(0, 256, (2, RESOLUTION, RESOLUTION, 3),
                        dtype=np.uint8).astype(np.float32) / 127.5 - 1.0


def mp_stage1_args(out_dir, extra):
    return ["--instance_prompt", "a sbu horse in szn style",
            "--content_forward_prompt", "a sbu horse",
            "--style_forward_prompt", "an image in szn style",
            "--rank", str(LORA_RANK), "--resolution", str(RESOLUTION),
            "--content_learning_rate", "5e-5", "--style_learning_rate",
            "5e-5", "--weight_learning_rate", "5e-3", "--similarity_lambda",
            "0.5", "--seed", "0", "--with_period_column_separation",
            "--sample_times", "1", "--max_train_steps",
            str(MP_STAGE1_STEPS), "--checkpointing_steps", "100",
            "--output_dir", out_dir] + extra


def mp_stage1_run(out_dir, extra, scale, capture=None):
    """One stage-1 run; the gradients scaled by `scale` (run D's power of
    two) so that the selection at step MP_STAGE1_SELECT picks columns.
    capture: a file that receives, at the selection step, each
    projection's LoRA tensors, gradients (as the selection reads them:
    summed over the processes, scaled) and state, with its label and the
    column-separation settings. Returns (trainer, report, per-step
    gradient norms, masks)."""
    import torch
    from video_style_transfer_tpu_torch.cli import train_unziplora
    from video_style_transfer_tpu_torch.lora.surgery import tree_get
    from video_style_transfer_tpu_torch.training.stage1 import lora_grads

    norms, assignments = [], []
    record = mp_grad_norms(norms)

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.detach().cpu().clone()
                for k, v in tree.items()}

    def on_grads(state, grads):
        for g in grads.values():
            g.mul_(scale)
        record(grads)
        if capture is not None and state.step == MP_STAGE1_SELECT:
            torch.save({"sep": assignments[0].sep, "captured": {
                path: (cpu(tree_get(state.params, path)["lora"]),
                       cpu(lora_grads(grads, path)),
                       cpu(tree_get(state.lora_state, path)), label)
                for path, label in assignments[0].assignments.items()}},
                capture)

    report = {}
    tr = train_unziplora.train(train_unziplora.build_parser().parse_args(
        mp_stage1_args(out_dir, extra)), report, images=mp_stage1_images(),
        on_grads=on_grads, on_setup=assignments.append)
    masks = torch.cat([tree_get(tr.state.lora_state, p)[f"mask_{b}"]
                       .flatten().cpu() for p in tr.assignments
                       for b in ("content", "style")])
    return tr, report, norms, masks


def mp_select(path):
    """One process's selection (training.stage1.select_projection on the
    card) from the tensors a stage-1 rank captured at its selection step:
    the masks, in mp_stage1_run's order, and the projection count."""
    import torch
    from video_style_transfer_tpu_torch.training.stage1 import (
        select_projection)
    from video_style_transfer_tpu_torch.utils.convert import to_device

    d = torch.load(path, weights_only=False)
    masks = []
    for lp, lg, st, label in d["captured"].values():
        picked = select_projection(to_device(lp, "cuda"),
                                   to_device(lg, "cuda"),
                                   to_device(st, "cuda"), label, d["sep"])
        masks += [picked[2].flatten().cpu(), picked[3].flatten().cpu()]
    return torch.cat(masks), len(d["captured"])


def mp_stage1(cfg, rank):
    """cli.train_unziplora.train with --data_parallel 2 at one row a
    process, through a selection from gradients scaled by run D's
    factor; rank 0 captures what its selection read (MP_SELECT_FILE)."""
    import torch
    from video_style_transfer_tpu_torch.cli.common import model_configs

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    root = os.path.join(cfg["root"], "stage1")
    tr, report, norms, masks = mp_stage1_run(
        root, ["--train_batch_size", "1", "--data_parallel", str(MP_WORLD),
               "--device", "cuda:0"], cfg["scale"],
        capture=(os.path.join(cfg["root"], MP_SELECT_FILE) if rank == 0
                 else None))
    counts = counters()
    per = expected_train_launches(model_configs(smoke=False, motion=False)[0],
                                  frames=1, resolution=RESOLUTION, steps=1,
                                  encoded=0)
    # each process encodes both instance images (their moments are the
    # whole set's)
    check_counts(f"data-parallel stage-1 (rank {rank})", counts,
                 stage1_launches(per, train_forwards=MP_STAGE1_STEPS,
                                 unet_calls=0, vae_calls=2))
    routes = check_routes(
        f"data-parallel stage-1 (rank {rank})", counts,
        per["flash_attention_fwd"] * MP_STAGE1_STEPS, 2,
        bwd_wgmma=per["flash_attention_bwd"] * MP_STAGE1_STEPS)
    leaves = {"/".join(map(str, p)): t.detach().cpu()
              for p, t in tr.optimizer.trainable}
    del tr
    torch.cuda.empty_cache()
    return {"losses": report["losses"], "phase": report["phase"],
            "step_s": report["step_s"], "setup_s": report["setup_s"],
            "grad_norms": norms, "masks": masks,
            "sums": [float(t.double().sum()) for t in leaves.values()],
            "tensors": leaves if rank == 0 else None, "launches": routes,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


# the payload of one bf16 UNet call's model-axis reductions a rank under
# --tp 2 at 1024^2 (a CFG pair): 3 reductions (attn1, attn2, ff) in each
# of the 10 level-1 layers of 2 x 4096 x 640 and the 60 level-2 layers of
# 2 x 1024 x 1280 (tp_reduced_bytes computes it from the config)
TP_UNET_BYTES_BF16 = 1_258_291_200


def tp_reduced_bytes(itemsize):
    """The payload (numel x itemsize) of one SDXL UNet call's model-axis
    reductions at RESOLUTION, a CFG pair: each spatial transformer layer
    reduces three (2, tokens, C) partial sums."""
    from video_style_transfer_tpu_torch.config import CROSS, UNetConfig
    cfg = UNetConfig.sdxl()
    n = len(cfg.block_out_channels)
    total = 0
    for lvl, c in enumerate(cfg.block_out_channels):
        per = cfg.transformer_layers_per_block[lvl]
        layers = ((cfg.layers_per_block if cfg.down_block_types[lvl] == CROSS
                   else 0)
                  + (cfg.layers_per_block + 1
                     if cfg.up_block_types[n - 1 - lvl] == CROSS else 0)
                  + (1 if lvl == n - 1 else 0)) * per
        total += 3 * layers * 2 * (RESOLUTION // 8 >> lvl) ** 2 * c * itemsize
    return total


def tp_unet_call(artifacts, device, grid=None):
    """One fp32 UNet call of the image path's CFG pair (mode both, the
    cross-attention k/v LoRA branches live, the other projections folded,
    seeded latents at t = 999): the weights built, LoRA-imported and
    folded whole, then, with `grid`, cut to this rank's slices. Returns
    the UNet output (fp32, CPU), K1/K2 launches by route and the bytes the
    model-axis reductions carried."""
    import torch
    from video_style_transfer_tpu_torch.cli import common, infer
    from video_style_transfer_tpu_torch.lora.surgery import fold_unziplora
    from video_style_transfer_tpu_torch.parallel import distributed, tensor
    from video_style_transfer_tpu_torch.pipelines.image import draw_noise
    from video_style_transfer_tpu_torch.pipelines.sampling import (
        make_cfg_denoiser)

    args = infer.build_parser().parse_args(image_argv(artifacts,
                                                      str(device)))
    res = RESOLUTION
    with torch.inference_mode():
        bundle = common.load_models(None, motion=False, dtype=torch.float32,
                                    seed=0, device=device)
        params, state = infer.load_lora(args, bundle.unet, device)
        bundle.unet = None
        params, _ = fold_unziplora(params, state, mode="both",
                                   fold_cross_kv=False)
        cond = common.make_conditioning(
            bundle, args.prompt, args.prompt_content, args.prompt_style,
            height=res, width=res)
        uncond = common.negative_conditioning(bundle, args.negative_prompt,
                                              height=res, width=res)
        if grid is not None:
            state = tensor.tp_shard_state(state, params, bundle.unet_cfg,
                                          grid)
            params = tensor.tp_shard(params, bundle.unet_cfg, grid)
        latents = draw_noise((1, res // 8, res // 8, 4),
                             common.seeded_generator(0)).to(device)
        outs = []
        reset_counters()
        distributed.MODEL_REDUCED_BYTES = 0
        eps_fn = make_cfg_denoiser(params, bundle.unet_cfg, uncond, cond,
                                   cfg_scale=5.0, mode="both", state=state,
                                   dtype=torch.float32)
        with kept_unet_outputs(outs):
            eps_fn(latents, torch.tensor(999.0, device=device))
        torch.cuda.synchronize()
        counts = counters()
    label = "fp32 UNet call" + ("" if grid is None else
                                f" (--tp 2 rank {grid.model_index})")
    routes = check_routes(label, counts, 0, 0, tf32x3=70, geglu_tf32x3=70)
    return {"unet": outs[0], "launches": routes,
            "reduced_bytes": distributed.MODEL_REDUCED_BYTES}


def mp_tp_unet(cfg, rank):
    """The --tp 2 fp32 twin: tp_unet_call on this rank's slices."""
    import torch
    from video_style_transfer_tpu_torch.parallel import mesh
    grid = mesh.create_mesh(data=1, model=MP_WORLD)
    torch.cuda.reset_peak_memory_stats()
    out = tp_unet_call(cfg["artifacts"], torch.device("cuda", 0), grid)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def mp_tp_image(cfg, rank):
    """cli.infer.generate with --tp 2: the image path (bf16, mode both,
    IMAGE_STEPS DPM-Solver++ steps) on this rank's heads and feed-forward
    columns."""
    import torch
    from video_style_transfer_tpu_torch.cli import infer
    from video_style_transfer_tpu_torch.parallel import distributed

    args = infer.build_parser().parse_args(
        image_argv(cfg["artifacts"], "cuda:0") + ["--tp", str(MP_WORLD)])
    torch.cuda.reset_peak_memory_stats()
    report = {}
    reset_counters()
    distributed.MODEL_REDUCED_BYTES = 0
    t0 = time.perf_counter()
    outs = infer.generate(args, report)
    total = time.perf_counter() - t0
    counts = counters()
    label = f"--tp 2 image (rank {rank})"
    check_counts(label, counts,
                 {**serving_launches(0, 0),
                  "flash_attention_fwd": 70 * IMAGE_STEPS + 1,
                  "geglu_projection": 70 * IMAGE_STEPS})
    routes = check_routes(label, counts, 70 * IMAGE_STEPS, 1)
    (name, img), = outs.items()
    rep = report["images"][name]
    return {"s": total, "weight_init_s": report["weight_init_s"],
            "text_encode_s": report["text_encode_s"],
            "denoise_step_s": rep["denoise_step_s"],
            "decode_s": rep["decode_s"], "image": img,
            "latents": rep["latents"], "launches": routes,
            "reduced_bytes": distributed.MODEL_REDUCED_BYTES,
            "report_reduced_bytes": rep["model_reduced_bytes"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def mp_child(config_path, rank):
    """One rank of the multi-process section: joins the gloo group (a
    file store under the section's directory) on cuda:0 and runs the
    probe, frame-parallel serving, frame-parallel stage 2, data-parallel
    stage 1 and tensor-parallel image serving (bf16, and the fp32 UNet
    call) in turn, writing its results for process 0 of the script to
    check."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(config_path) as f:
        cfg = json.load(f)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + cfg["store"],
                            world_size=MP_WORLD, rank=rank)
    out, seconds = {}, {}
    for name, fn in (("probe", lambda: mp_probe(rank)),
                     ("serving", lambda: mp_serving(cfg, rank)),
                     ("serving_fp32", lambda: mp_serving(cfg, rank, True)),
                     ("stage2", lambda: mp_stage2(cfg, rank)),
                     ("stage2_fp32", lambda: mp_stage2(cfg, rank, True)),
                     ("stage1", lambda: mp_stage1(cfg, rank)),
                     ("tp_image", lambda: mp_tp_image(cfg, rank)),
                     ("tp_unet_fp32", lambda: mp_tp_unet(cfg, rank))):
        dist.barrier()
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = seconds
    torch.save(out, os.path.join(cfg["root"], f"rank{rank}.pt"))
    dist.destroy_process_group()


def mp_launch(cfg):
    """Start both ranks, wait for both; a rank that fails stops the other
    and fails the run."""
    path = os.path.join(cfg["root"], "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    procs, logs = [], []
    for rank in range(MP_WORLD):
        log = open(os.path.join(cfg["root"], f"rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--multi-process-child", path, str(rank)], cwd=HERE,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.time() + MP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(cfg["root"], f"rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            print(f"--- rank {rank} (exit {p.returncode}) ---\n{tail}",
                  flush=True)
            fail(f"multi-process rank {rank} exited with {p.returncode}")
    import torch
    return [torch.load(os.path.join(cfg["root"], f"rank{r}.pt"),
                       weights_only=False) for r in range(MP_WORLD)]


def normwise(got, want):
    import torch
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def mp_ranks_agree(label, ranks):
    """The ranks hold bitwise-equal tensors (equal float64 sums) and
    report the same (global) losses."""
    if any(r["sums"] != ranks[0]["sums"] for r in ranks[1:]):
        fail(f"{label}: the ranks' tensors differ")
    key = "loss" if "loss" in ranks[0] else "losses"
    if any(r[key] != ranks[0][key] for r in ranks[1:]):
        fail(f"{label}: the ranks' losses differ: {[r[key] for r in ranks]}")


def mp_compare_tensors(label, ranks, want, limit):
    """The ranks agree (mp_ranks_agree), and rank 0's tensors are within
    `limit` of one process's, normwise over all of them."""
    import torch
    mp_ranks_agree(label, ranks)
    got = ranks[0]["tensors"]
    if set(got) != set(want):
        fail(f"{label}: the trained tensors' paths differ")
    err = normwise(torch.cat([got[k].flatten() for k in want]),
                   torch.cat([want[k].flatten() for k in want]))
    if not err <= limit:
        fail(f"{label}: the tensors after the steps are {err:.3e} from one "
             f"process's normwise (limit {limit:.3e})")
    return err


def mp_compare_grads(label, ranks, want, limit):
    errs = []
    for r in ranks:
        if len(r["grad_norms"]) != len(want):
            fail(f"{label}: {len(r['grad_norms'])} steps, expected "
                 f"{len(want)}")
        errs.append(max(normwise(g, w) for g, w in zip(r["grad_norms"],
                                                        want)))
    if not max(errs) <= limit:
        norms = [[round(float(g.norm()), 6) for g in r["grad_norms"]]
                 for r in ranks]
        fail(f"{label}: per-tensor gradient norms {max(errs):.3e} from one "
             f"process's normwise (limit {limit:.3e}); global "
             f"norms a step {norms}, one process's "
             f"{[round(float(w.norm()), 6) for w in want]}")
    return max(errs)


def mp_compare_losses(label, got, want, limit):
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or not err <= limit:
        fail(f"{label}: losses {got} against one process's {want} (relative "
             f"limit {limit:.3e})")
    return err


def mp_exchange_bytes(itemsize, steps):
    """({level: bytes a rank sends in one motion module}, bytes a rank
    sends in a serving run of `steps` steps): each module sends (n-1)/n of
    its (2 CFG rows x F/n frames x HW x C) activation to the other ranks,
    twice (in and back); SDXL has 5 modules a level, one UNet call a
    step."""
    per_module = {lvl: 2 * (MP_WORLD - 1) * 2 * (NUM_FRAMES // MP_WORLD)
                  * (RESOLUTION // 8 >> lvl) ** 2 * c * itemsize // MP_WORLD
                  for lvl, c in enumerate((320, 640, 1280))}
    return per_module, steps * 5 * sum(per_module.values())


def multi_process_section(tmp, artifacts, motion_checkpoint, serving_ref,
                          scale, image_ref, image_routes):
    """Two processes on the one card over gloo: the probe, then
    ``cli.infer_video`` with --frame_parallel 2, ``cli.train_animatediff``
    with --frame_parallel 2 and ``cli.train_unziplora`` with
    --data_parallel 2 through their normal entry points, each held against
    one process: the fp32 serving and stage-2 runs against one-process
    fp32 runs made here after the ranks exit (the gates), bf16 serving
    against the serving phase's mode both (same seed; readings and the
    frames' levels), stage 1 against one process at batch 2 and its masks
    against one process's selection from the ranks' summed gradients;
    then ``cli.infer --tp 2``: its fp32 UNet call against one process's
    (the gate), its bf16 image and latents against the image path's
    (`image_ref`, readings), its K1 and K2 launches by route against the
    image path's (`image_routes`) and its reductions' bytes against the
    shapes'. Returns the readings."""
    import numpy as np
    import torch
    from video_style_transfer_tpu_torch.cli import infer_video

    card = card_line()
    root = os.path.join(tmp, "multi_process")
    os.makedirs(root)
    cfg = {"root": root, "store": os.path.join(root, "store"),
           "artifacts": artifacts, "motion_checkpoint": motion_checkpoint,
           "scale": scale}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mp_launch(cfg)
    ranks_s = time.perf_counter() - t0
    label = f"two ranks time-sharing one {card}"
    readings = {"card": card, "ranks_s": ranks_s,
                "seconds_by_phase": [r["seconds"] for r in ranks]}
    readings["probe"] = ranks[0]["probe"]
    phase_s = [{k: round(v, 3) for k, v in r["seconds"].items()}
               for r in ranks]
    print(f"multi-process ({label}): gloo probe on CUDA tensors "
          f"(all_to_all_single, all_reduce, all_gather, barrier) passed on "
          f"both ranks (gloo's bf16 all_reduce, unused: largest distance "
          f"from the rounded float32 sum "
          f"{ranks[0]['probe']['bf16_all_reduce_max_abs_err']:.3e}); the "
          f"ranks' phases took {phase_s} s, {ranks_s:.1f} s in all with "
          f"start-up", flush=True)

    def compare_serving():
        # each rank's first UNet output (its 16 of the 32 rows, same
        # inputs), latents and frames against one process's mode both: the
        # fp32 run against one process's fp32 run made here (same seed,
        # inputs, weights and steps), the gate; the bf16 run against the
        # serving phase's, readings, its frames held to the levels
        t0 = time.perf_counter()
        fp32_unet, fp32_report = [], {}
        with kept_unet_outputs(fp32_unet):
            fp32_outs = infer_video.generate(
                infer_video.build_parser().parse_args(mp_serving_args(
                    ["--unziplora_name_or_path", artifacts,
                     "--motion_checkpoint", motion_checkpoint,
                     "--device", "cuda"], fp32=True)),
                fp32_report)
        fp32_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        one = {"bf16": serving_ref,
               "fp32": {"unet": fp32_unet[0],
                        "latents": fp32_report["both"]["latents"],
                        "frames": fp32_outs["both"]}}
        limits = {"bf16": (None, None),
                  "fp32": (MP_FP32_NORMWISE, MP_FP32_NORMWISE)}
        print(f"  one process's fp32 serving: {MP_FP32_STEPS} step, "
              f"{fp32_s:.1f} s", flush=True)
        worst = {}
        for prec, key in (("bf16", "serving"), ("fp32", "serving_fp32")):
            ref = one[prec]
            half = ref["latents"].shape[0]
            w = worst[prec] = {"unet": 0.0, "latents": 0.0, "mean": 0.0,
                               "p99": 0.0}
            for rank, r in enumerate(ranks):
                s = r[key]
                a, b = s["frame_range"]
                if (a, b) != (rank * NUM_FRAMES // MP_WORLD,
                              (rank + 1) * NUM_FRAMES // MP_WORLD) or \
                        s["shape"] != tuple(ref["frames"].shape):
                    fail(f"{key} rank {rank}: frames {a}..{b} of {s['shape']}")
                # a rank's rows: [uncond frames a..b, cond frames a..b]
                rows = torch.cat([ref["unet"][a:b],
                                  ref["unet"][half + a:half + b]])
                got = {"unet": normwise(s["unet"], rows),
                       "latents": normwise(s["latents"], ref["latents"][a:b])}
                diff = np.abs(s["frames"].astype(np.int16)
                              - ref["frames"][a:b].astype(np.int16))
                got["mean"] = float(diff.mean())
                got["p99"] = float(np.percentile(diff, 99))
                for k in w:
                    w[k] = max(w[k], got[k])
                held = ("reading" if limits[prec][0] is None else
                        f"limits {limits[prec][0]:.3e}, "
                        f"{limits[prec][1]:.3e}")
                print(f"  serving {prec} rank {rank}: frames {a}..{b - 1}, "
                      f"weight init {s['weight_init_s']:.3f} s, denoise steps "
                      f"{', '.join(f'{t:.3f}' for t in s['denoise_step_s'])}"
                      f" s,"
                      f" decode {s['decode_s']:.3f} s, total {s['s']:.3f} s, "
                      f"peak {s['peak_gib']:.2f} GiB; from one process's "
                      f"{prec} run, normwise: first UNet output "
                      f"{got['unet']:.3e}, latents {got['latents']:.3e} "
                      f"({held}); frames mean {got['mean']:.3f} p99 "
                      f"{got['p99']:.1f} levels (limits {MP_FRAME_LEVELS}); "
                      f"launches by kernel {s['launches']}; all-to-all sent "
                      f"{s['exchanged_bytes']} bytes", flush=True)
            unet_lim, lat_lim = limits[prec]
            if not ((unet_lim is None or w["unet"] <= unet_lim)
                    and (lat_lim is None or w["latents"] <= lat_lim)
                    and w["mean"] <= MP_FRAME_LEVELS[0]
                    and w["p99"] <= MP_FRAME_LEVELS[1]):
                fail(f"frame-parallel {prec} serving differs from one "
                     f"process: {w} (limits {limits[prec]}, frames "
                     f"{MP_FRAME_LEVELS})")
        for prec, key, itemsize, steps in (
                ("bf16", "serving", 2, STEPS),
                ("fp32", "serving_fp32", 4, MP_FP32_STEPS)):
            per_module, want_bytes = mp_exchange_bytes(itemsize, steps)
            for rank, r in enumerate(ranks):
                if r[key]["exchanged_bytes"] != want_bytes:
                    fail(f"{key} rank {rank} sent {r[key]['exchanged_bytes']} "
                         f"bytes by all-to-all, expected {want_bytes}")
            print(f"  a motion module's exchange in {prec}, each rank: "
                  f"{per_module} bytes at levels 0-2 ({want_bytes} a rank "
                  f"over {steps} steps, as counted)", flush=True)
        readings["serving"] = {
            "bf16": worst["bf16"], "fp32": worst["fp32"],
            "module_bytes_by_level": mp_exchange_bytes(2, STEPS)[0],
            "steps_s": [r["serving"]["denoise_step_s"] for r in ranks],
            "decode_s": [r["serving"]["decode_s"] for r in ranks],
            "peak_gib": [r["serving"]["peak_gib"] for r in ranks],
            "launches": [r["serving"]["launches"] for r in ranks]}
        readings["serving_fp32"] = {
            "steps_s": [r["serving_fp32"]["denoise_step_s"] for r in ranks],
            "decode_s": [r["serving_fp32"]["decode_s"] for r in ranks],
            "peak_gib": [r["serving_fp32"]["peak_gib"] for r in ranks],
            "one_process_s": fp32_s,
            "launches": [r["serving_fp32"]["launches"] for r in ranks]}

    def compare_stage2():
        # the fp32 run against one process's fp32 run of the same cut
        # configuration, the gate; the bf16 run (checkpoint and resume)
        # held to its ranks' agreement, its resume and its peaks, its
        # first loss a reading beside one process's fp32 first loss
        t0 = time.perf_counter()
        tr, report, norms, _, peak = mp_stage2_run(
            os.path.join(root, "stage2_one_fp32"),
            ["--device", "cuda", "--unziplora_name_or_path", artifacts],
            "one-process stage-2 fp32", fp32=True)
        want = {"/".join(map(str, p)): t.detach().cpu()
                for p, t in tr.trainable}
        del tr
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t0
        out = readings["stage2"] = {}
        for prec, key in (("fp32", "stage2_fp32"), ("bf16", "stage2")):
            label = f"frame-parallel stage 2 {prec}"
            s2 = [r[key] for r in ranks]
            peaks = sum(r["peak_gib"] for r in s2)
            if peaks * 2 ** 30 >= 80e9:
                fail(f"the two {label} ranks peaked at {peaks:.2f} GiB "
                     f"together")
            if prec == "fp32":
                loss_err = max(mp_compare_losses(label, r["loss"],
                                                 report["loss"],
                                                 MP_FP32_NORMWISE)
                               for r in s2)
                grad_err = mp_compare_grads(label, s2, norms,
                                            MP_FP32_NORMWISE)
                tensor_err = mp_compare_tensors(label, s2, want,
                                                MP_FP32_NORMWISE)
                held = (f"worst relative {loss_err:.3e}; per-tensor "
                        f"gradient norms {grad_err:.3e} normwise; tensors "
                        f"after the step {tensor_err:.3e} normwise (limits "
                        f"{MP_FP32_NORMWISE:g}), equal on both ranks")
                out[prec] = {"loss_rel": loss_err,
                             "grad_norms_normwise": grad_err,
                             "tensors_normwise": tensor_err}
            else:
                mp_ranks_agree(label, s2)
                first = abs(s2[0]["loss"][0] - report["loss"][0]) \
                    / abs(report["loss"][0])
                held = (f"first loss {first:.3e} from one process's fp32 "
                        f"(a reading); tensors and losses equal on both "
                        f"ranks; resumed from checkpoint-1 bitwise on both "
                        f"ranks (resumed losses "
                        f"{[r['resumed_loss'] for r in s2]})")
                out[prec] = {"first_loss_rel_to_one_fp32": first,
                             "resume_bitwise": True}
            steps = MP_FP32_STEPS if prec == "fp32" else MP_TRAIN_STEPS
            print(f"  stage 2 {prec} (--frame_parallel 2, {MP_TRAIN_RES}^2, "
                  f"{TRAIN_FRAMES} frames, {steps} steps): losses "
                  f"{[r['loss'] for r in s2]} against one process's fp32 "
                  f"{report['loss']} ({held}); step seconds "
                  f"{[r['step_s'] for r in s2]} (one process fp32 "
                  f"{report['step_s']}); peaks "
                  f"{[round(r['peak_gib'], 2) for r in s2]} GiB "
                  f"({peaks:.2f} together; one process fp32 {peak:.2f}); "
                  f"launches by kernel {[r['launches'] for r in s2]}",
                  flush=True)
            out[prec].update(step_s=[r["step_s"] for r in s2],
                             peak_gib=[r["peak_gib"] for r in s2])
        out["one_fp32"] = {"step_s": report["step_s"], "peak_gib": peak,
                           "s": one_s}
        out["launches"] = [r["stage2"]["launches"] for r in ranks]
        readings["stage2_fp32"] = {"launches": [r["stage2_fp32"]["launches"]
                                                for r in ranks]}

    def compare_stage1():
        # against one process at batch 2; the masks against one process's
        # selection from what rank 0's selection read
        t0 = time.perf_counter()
        tr, rep1, norms1, masks1 = mp_stage1_run(
            os.path.join(root, "stage1_one"),
            ["--train_batch_size", "2", "--device", "cuda"], scale)
        want = {"/".join(map(str, p)): t.detach().cpu()
                for p, t in tr.optimizer.trainable}
        del tr
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t0
        label = "data-parallel stage 1"
        s1 = [r["stage1"] for r in ranks]
        if rep1["phase"] != ["reset", "select"] or \
                any(r["phase"] != rep1["phase"] for r in s1):
            fail(f"stage-1 phases {[r['phase'] for r in s1]} and "
                 f"{rep1['phase']}, expected reset, select")
        loss_err = max(mp_compare_losses(
            label, [x["loss"] for x in r["losses"]],
            [x["loss"] for x in rep1["losses"]], MP_LOSS_REL) for r in s1)
        grad_err = mp_compare_grads(label, s1, norms1, MP_GRAD_NORMWISE)
        tensor_err = mp_compare_tensors(label, s1, want, MP_TENSOR_NORMWISE)
        cols = int(s1[0]["masks"].sum())
        if not 0 < cols < masks1.numel():
            fail(f"the two-process stage-1 selection picked {cols} of "
                 f"{masks1.numel()} columns")
        if any(not torch.equal(r["masks"], s1[0]["masks"]) for r in s1):
            fail("the stage-1 ranks' masks differ")
        t1 = time.perf_counter()
        picked, projections = mp_select(os.path.join(root, MP_SELECT_FILE))
        select_s = time.perf_counter() - t1
        if not torch.equal(picked, s1[0]["masks"]):
            fail(f"the two-process stage-1 masks differ from one process's "
                 f"selection from the ranks' summed gradients in "
                 f"{int((picked != s1[0]['masks']).sum())} columns")
        # a reading: one process's gradients differ from the two ranks'
        # sum in their last bf16 bits, which can move a column across the
        # top-k boundary
        moved = int((s1[0]["masks"] != masks1).sum())
        print(f"  stage 1 (--data_parallel 2, one row a rank, {RESOLUTION}^2, "
              f"rank {LORA_RANK}, gradients x{scale:g}): phases "
              f"{rep1['phase']}; "
              f"losses {[[x['loss'] for x in r['losses']] for r in s1]} "
              f"against "
              f"one process's {[x['loss'] for x in rep1['losses']]} (worst "
              f"relative {loss_err:.3e}); per-tensor gradient norms "
              f"{grad_err:.3e} normwise; LoRA leaves {tensor_err:.3e} "
              f"normwise, "
              f"equal on both ranks; masks equal on both ranks ({cols} of "
              f"{masks1.numel()} columns) and to one process's selection "
              f"from the ranks' summed gradients ({projections} "
              f"projections, {select_s:.1f} s); {moved} columns differ "
              f"from one process's selection from its own gradients "
              f"({int(masks1.sum())} columns); step seconds "
              f"{[r['step_s'] for r in s1]} (one process {rep1['step_s']}); "
              f"peaks {[round(r['peak_gib'], 2) for r in s1]} GiB; launches "
              f"by kernel {[r['launches'] for r in s1]}; one-process run "
              f"{one_s:.1f} s", flush=True)
        readings["stage1"] = {
            "loss_rel": loss_err, "grad_norms_normwise": grad_err,
            "tensors_normwise": tensor_err, "masks_equal_on_ranks": True,
            "masks_equal_to_one_process_selection": True,
            "columns": cols, "projections": projections,
            "columns_differing_from_one_process": moved,
            "step_s": [r["step_s"] for r in s1],
            "one_step_s": rep1["step_s"],
            "peak_gib": [r["peak_gib"] for r in s1],
            "launches": [r["launches"] for r in s1]}

    def compare_tp():
        # the fp32 twin against one process's fp32 call made here, the
        # gate; bf16 serving against the image path's run, readings; the
        # launches by route and the reductions' bytes exact
        t0 = time.perf_counter()
        one = tp_unet_call(artifacts, torch.device("cuda"))
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t0
        want_bytes = {"fp32": tp_reduced_bytes(4),
                      "bf16": IMAGE_STEPS * tp_reduced_bytes(2)}
        if tp_reduced_bytes(2) != TP_UNET_BYTES_BF16:
            fail(f"the reductions of a bf16 UNet call come to "
                 f"{tp_reduced_bytes(2)} bytes, not {TP_UNET_BYTES_BF16}")
        keys = ("flash_attention_fwd", "flash_attention_fwd_wide",
                "flash_attention_fwd_tf32x3", "flash_attention_fwd_fma",
                "geglu_projection", "geglu_projection_tf32x3")
        out = readings["tp"] = {"one_fp32_s": one_s}
        unet_err = []
        for rank, r in enumerate(ranks):
            u, im = r["tp_unet_fp32"], r["tp_image"]
            unet_err.append(normwise(u["unet"], one["unet"]))
            for label, got, want in (
                    ("fp32 UNet call", u["launches"], one["launches"]),
                    ("bf16 image", im["launches"], image_routes)):
                if any(got[k] != want[k] for k in keys):
                    fail(f"--tp 2 {label} rank {rank}: K1/K2 launches "
                         f"{ {k: got[k] for k in keys} }, one process's "
                         f"{ {k: want[k] for k in keys} }")
            for label, got, want in (
                    ("fp32 UNet call", u["reduced_bytes"],
                     want_bytes["fp32"]),
                    ("bf16 image", im["reduced_bytes"], want_bytes["bf16"]),
                    ("bf16 image (report)", im["report_reduced_bytes"],
                     want_bytes["bf16"])):
                if got != want:
                    fail(f"--tp 2 {label} rank {rank}: the model-axis "
                         f"reductions carried {got} bytes, expected {want}")
        lat_err = [normwise(r["tp_image"]["latents"], image_ref["latents"])
                   for r in ranks]
        diffs = [np.abs(r["tp_image"]["image"].astype(np.int16)
                        - image_ref["image"].astype(np.int16))
                 for r in ranks]
        same = all(np.array_equal(r["tp_image"]["image"],
                                  ranks[0]["tp_image"]["image"])
                   for r in ranks)
        for rank, r in enumerate(ranks):
            im = r["tp_image"]
            print(f"  --tp 2 rank {rank}: fp32 UNet call (CFG pair, mode "
                  f"both, live cross-attention LoRA) {unet_err[rank]:.3e} "
                  f"from one process's normwise (limit "
                  f"{MP_FP32_NORMWISE:g}), peak "
                  f"{r['tp_unet_fp32']['peak_gib']:.2f} GiB; bf16 image "
                  f"path: weight init {im['weight_init_s']:.3f} s, fold and "
                  f"text encode {im['text_encode_s']:.3f} s, denoise steps "
                  f"{', '.join(f'{t:.3f}' for t in im['denoise_step_s'])} s, "
                  f"decode {im['decode_s']:.3f} s, total {im['s']:.3f} s, "
                  f"peak {im['peak_gib']:.2f} GiB; latents {lat_err[rank]:.3e}"
                  f" from the image path's normwise, image mean "
                  f"{float(diffs[rank].mean()):.3f} p99 "
                  f"{float(np.percentile(diffs[rank], 99)):.1f} max "
                  f"{int(diffs[rank].max())} levels (readings); launches by "
                  f"kernel {im['launches']}", flush=True)
        print(f"  --tp 2: model-axis reductions a rank "
              f"{want_bytes['bf16'] // IMAGE_STEPS} bytes a bf16 UNet call "
              f"({IMAGE_STEPS} calls, {want_bytes['bf16']} as counted), "
              f"{want_bytes['fp32']} an fp32 call, as counted; K1 and K2 "
              f"launches a rank equal one process's by route; the ranks' "
              f"images {'equal' if same else 'differ'}; one process's fp32 "
              f"call {one_s:.1f} s", flush=True)
        if not max(unet_err) <= MP_FP32_NORMWISE:
            fail(f"--tp 2 fp32 UNet call {max(unet_err):.3e} from one "
                 f"process's normwise (limit {MP_FP32_NORMWISE:g})")
        for r in ranks:
            img = r["tp_image"]["image"]
            if img.shape != image_ref["image"].shape or float(img.std()) == 0:
                fail(f"--tp 2 image {img.shape}, std {float(img.std())}")
        out.update(
            unet_fp32_normwise=max(unet_err),
            latents_normwise=max(lat_err),
            image_mean_levels=max(float(d.mean()) for d in diffs),
            image_p99_levels=max(float(np.percentile(d, 99)) for d in diffs),
            image_max_levels=max(int(d.max()) for d in diffs),
            ranks_equal=same, reduced_bytes_per_bf16_call=TP_UNET_BYTES_BF16,
            reduced_bytes_fp32_call=want_bytes["fp32"],
            steps_s=[r["tp_image"]["denoise_step_s"] for r in ranks],
            decode_s=[r["tp_image"]["decode_s"] for r in ranks],
            peak_gib=[r["tp_image"]["peak_gib"] for r in ranks])
        readings["tp_image"] = {"launches": [r["tp_image"]["launches"]
                                             for r in ranks]}
        readings["tp_unet_fp32"] = {"launches": [
            r["tp_unet_fp32"]["launches"] for r in ranks]}

    # every comparison runs and prints; any that failed fails the run
    failed = []
    for compare in (compare_serving, compare_stage2, compare_stage1,
                    compare_tp):
        try:
            compare()
        except SystemExit:
            failed.append(compare.__name__)
    if failed:
        fail(f"multi-process comparisons failed: {failed}")
    return readings


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--multi-process-child":
        return mp_child(sys.argv[2], int(sys.argv[3]))
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(HERE, "video_style_transfer_tpu_torch")):
        fail("run from a checkout of the repository (the port's package is "
             "missing beside this script)")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    from video_style_transfer_tpu_torch.ops import cuda_build
    start = t0 = time.perf_counter()
    sections = []  # (name, seconds since the start), printed at the end

    def section(name):
        sections.append((name, time.perf_counter() - start))

    cuda_build.library()
    built = cuda_build.build_info
    log = built["log"].splitlines()
    spills, entry = [], None
    for ln in log:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln and " 0 bytes spill stores" not in ln:
            spills.append(f"{entry}: {ln.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if built['built'] else 'cached'}; nvcc "
          f"{built['seconds'] or 0:.1f} s), "
          f"{sum('Used' in ln for ln in log)} kernels, "
          f"{len(spills)} with register spills", flush=True)
    for ln in spills:
        print(f"  {ln}", flush=True)

    section("build")
    print("kernels vs plain versions:", flush=True)
    phases = kernel_phases()
    section("forward kernel phases")
    phases.update(bwd_phases())
    section("backward kernel phases")
    phases["layer_norm"], ln_launches = layer_norm_phases()
    small_reference()
    small_training_reference()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        small_cli_reference(tmp)
        section("K7 and the small references")
        # before stage 2, whose clips go through it
        native = native_phase()
        section("native preprocessing")
        # the trainer first: serving reads the checkpoint it writes
        stage2_counts, motion_checkpoint, adam8 = stage2_path(tmp)
        torch.cuda.empty_cache()
        section("stage 2")
        stage1_counts, stage1 = stage1_path(tmp)
        torch.cuda.empty_cache()
        section("stage 1")
        from video_style_transfer_tpu_torch.config import UNetConfig
        artifacts = os.path.join(tmp, "stage1")
        t0 = time.perf_counter()
        n = write_lora_artifacts(artifacts, UNetConfig.sdxl(),
                                 rank=LORA_RANK, seed=11, device="cuda",
                                 up_scale=0.5)
        print(f"artifacts: rank-{LORA_RANK} content/style LoRAs and mergers "
              f"of {n} projections written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        precision, precision_counts = stage2_precision(artifacts)
        torch.cuda.empty_cache()
        section("stage-2 precision")
        serving_counts, serving_ref = main_path(artifacts,
                                                motion_checkpoint)
        by_path = {"serving": serving_counts,
                   "stage2": stage2_counts,
                   "stage2_fp32": precision_counts,
                   "stage1": stage1_counts}
        section("serving")
        by_path["image"], image_ref = image_path(artifacts)
        torch.cuda.empty_cache()
        by_path["bf16_decode"] = vae_bf16_decode_path()
        section("image and bf16 decode")
        by_path["vae_grad"] = vae_grad_path()
        torch.cuda.empty_cache()
        section("VAE gradients")
        lpips_path, aux = lpips_phase(tmp, serving_ref)
        aux["runbook"] = runbook_phase(tmp, lpips_path)
        aux["native"] = native
        torch.cuda.empty_cache()
        section("LPIPS, compare_outputs and the runbook")
        multi = multi_process_section(tmp, artifacts, motion_checkpoint,
                                      serving_ref, stage1["D"]["scale"],
                                      image_ref, by_path["image"])
        for name in ("serving", "serving_fp32", "stage2", "stage2_fp32",
                     "stage1", "tp_image", "tp_unet_fp32"):
            # both ranks' launches by kernel and route
            per_rank = multi[name].pop("launches")
            by_path[f"two_process_{name}"] = {
                k: (sum(r[k] for r in per_rank) if isinstance(v, int)
                    else {kk: sum(r[k][kk] for r in per_rank) for kk in v})
                for k, v in per_rank[0].items()}
        section("multi-process (two ranks time-sharing the card)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_path["layer_norm_phase"] = {"layer_norm": ln_launches}
    main_paths = ("serving", "stage2", "image", "bf16_decode", "stage2_fp32",
                  "stage1", "vae_grad")

    csrc = "video_style_transfer_tpu_torch/csrc/"
    jax_ops = "video_style_transfer_tpu/ops/"
    sources = {
        # K1's bf16 route at d <= 256 (every UNet self-attention) and at d
        # >= 320 (the wide kernel: the VAE under --vae_dtype bfloat16),
        # its FMA route at fp32 d = 512 (the VAE's mid-block attention)
        # and at d from 128 to 448 (on no path; its phase at d = 448
        # reaches the JAX package's unpacked kernel)
        "flash_attention_fwd": ("flash_attention_sm90.cu",
                                "flash_attention.py:253"),
        "flash_attention_fwd_wide": ("flash_attention_wide.cu",
                                     "flash_attention.py:160"),
        "flash_attention_fwd_fma": ("flash_attention_f32.cu",
                                    "flash_attention.py:160"),
        # K1 and K4 in fp32 at d = 64 (every UNet self-attention under
        # --mixed_precision no; the stage-2 precision check's fp32 steps)
        "flash_attention_fwd_tf32x3": ("flash_attention_tf32.cu",
                                       "flash_attention.py:253"),
        "flash_attention_bwd_tf32x3": ("flash_attention_tf32.cu",
                                       "flash_attention.py:596"),
        "flash_attention_fwd_fma_d448": ("flash_attention_f32.cu",
                                         "flash_attention.py:50"),
        # K2's bf16 route (every feed-forward of the bf16 paths) and its
        # fp32 route (every feed-forward under --mixed_precision no; the
        # stage-2 precision check's fp32 steps)
        "geglu_projection": ("geglu.cu", "geglu.py:100"),
        "geglu_projection_tf32x3": ("geglu.cu", "geglu.py:100"),
        "temporal_attention": ("temporal_attention.cu",
                               "temporal_attention.py:37"),
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "flash_attention.py:596"),
        # K4 at d = 128-512, D split across the blocks of a cluster (bf16,
        # wgmma + TMA) or a block's warps (fp32, 3xTF32): the VAE gradient
        # path's mid-block attention
        "flash_attention_bwd_sliced": ("flash_attention_bwd_sliced.cu",
                                       "flash_attention.py:596"),
        "flash_attention_bwd_sliced_tf32x3": ("flash_attention_tf32.cu",
                                              "flash_attention.py:596"),
        # not a TPU kernel: JAX computes delta in XLA at this line
        "flash_attention_bwd_delta": ("flash_attention_bwd.cu",
                                      "flash_attention.py:657"),
        "temporal_attention_bwd": ("temporal_attention_bwd.cu",
                                   "temporal_attention.py:129"),
        # K1's d=192 instance; no path of the port has that head dim
        "flash_attention_fwd_d192": ("flash_attention_sm90.cu",
                                     "flash_attention.py:50"),
        # no model calls it (as in the JAX package): its launches are
        # those of its own phase
        "layer_norm": ("layer_norm.cu", "layer_norm.py:60"),
    }
    wgmma_ptxas = sm90_ptxas(log)
    ptxas = {"flash_attention_sm90.cu": {d: r for d, r in wgmma_ptxas.items()
                                         if int(d) <= 256},
             "flash_attention_wide.cu": {d: r for d, r in wgmma_ptxas.items()
                                         if int(d) >= 320},
             "flash_attention_f32.cu": fma_ptxas(log),
             "flash_attention_bwd.cu": bwd_ptxas(log),
             "flash_attention_tf32.cu": tf32_ptxas(log),
             "flash_attention_bwd_sliced.cu": sliced_ptxas(log),
             "temporal_attention.cu": ta_ptxas(log),
             "temporal_attention_bwd.cu": ta_bwd_ptxas(log),
             "geglu.cu": geglu_ptxas(log)}
    kernels = []
    for name, (src, replaces) in sources.items():
        first = phases[name][0]  # the path's principal shape
        launches = {path: c.get(name, 0) for path, c in by_path.items()}
        entry = {
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": jax_ops + replaces,
            "launches": sum(launches[path] for path in main_paths),
            "launches_by_path": launches,
            "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "phases": phases[name]}
        if src in ptxas:
            entry["ptxas"] = ptxas[src]
        if name == "flash_attention_bwd_sliced_tf32x3":
            entry["ptxas"] = ptxas["flash_attention_bwd_sliced.cu"]["fp32"]
        elif name == "flash_attention_bwd_sliced":
            entry["ptxas"] = ptxas["flash_attention_bwd_sliced.cu"]["bf16"]
        if name == "temporal_attention":
            entry["kernel"] = "ta_fwd_mma_kernel"
        if name == "temporal_attention_bwd":
            entry["kernel"] = "ta_bwd_mma_kernel"
        if name == "flash_attention_bwd_delta":
            entry["note"] = ("not a TPU kernel: the JAX package computes "
                             "delta in XLA, in K4's launcher "
                             "_flash_bwd_bhsd")
        if name == "flash_attention_bwd":
            entry["launches_by_route"] = {
                r: sum(by_path[path]["flash_attention_bwd_by_route"][r]
                       for path in main_paths)
                for r in ("wgmma", "tf32x3", "wgmma_sliced",
                          "tf32x3_sliced")}
        kernels.append(entry)
    section("ptxas report")
    prev = 0.0
    parts = []
    for name, at in sections:
        parts.append(f"{name} {at - prev:.1f}")
        prev = at
    print(f"seconds by section ({card_line()}): {', '.join(parts)}; total "
          f"{prev:.1f} after the imports", flush=True)
    print(json.dumps({"stage2_precision": precision, "adamw8bit": adam8,
                      "stage1": stage1, "multi_process": multi,
                      "native_lpips_runbook": aux,
                      "bf16_decode_s_per_frame":
                          by_path["bf16_decode"]["decode_s_per_frame"],
                      "vae_grad": by_path["vae_grad"].pop("readings")}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
