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
   report fails if a K3 or K5 kernel spills. K4 has two routes
   (`bwd_route`): bf16 on wgmma + TMA, fp32 on
   mma.sync at 3xTF32; its phases (the train step's two levels and a
   ragged length, each in bf16 and fp32) also print the bound at the
   two-kernel design's 14 flops, and its delta kernel is held to the torch
   formula and timed beside torch.linalg.vecdot, one PyTorch call of the
   same function.
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
     3 and p99 16 uint8 levels of the fp32 decode of the same latents.
   On each path K1's launches are also counted by route: every bf16 UNet
   attention on the wgmma route's d <= 256 kernel, every bf16 VAE
   attention on its wide kernel, every fp32 VAE attention on the FMA
   one; K4's: every backward of the trainer on the wgmma route, each with
   one delta launch; and K2's: every bf16 feed-forward on its wgmma
   route, every fp32 one on its 3xTF32 route.
5. Prints a JSON line of the stage-2 precision, 8-bit AdamW, stage-1 and
   bf16 decode readings, then one JSON line with every kernel's numbers
   (K1 as its five kernels, the FMA route's d = 448 instance standing for
   the JAX package's unpacked kernel, K4 as its two routes, K4's delta as a
   kernel of its own, K2 as its two routes, with the wgmma kernels', the
   FMA kernels', the 3xTF32 kernels', K4's and K2's and K3's registers,
   spills and wgmma serialisation from nvcc's report; the FMA, 3xTF32,
   K3, K4, K2 and K1 wgmma kernels must not spill, and K1's and K2's
   wgmma kernels must not have their products serialised; the
   stage-2 precision check's launches count as a path of their own,
   "stage2_fp32", and stage 1's as "stage1"), then the last line
   {"ok": true, "device": {...}}. Any failure exits non-zero before
   that. Each K1 and K2 bf16 phase and each K3 phase also prints its
   share of the bound and its time against SDPA's or the three calls'.
"""
from __future__ import annotations

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
             50)):
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
    for tag, (m, c), dt, iters in (
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
            ("stage1_l1 (4096,640->2560)", (4096, 640), torch.float32, 20)):
        inner = 4 * c
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
            ("clip32_l2", (32, 1024, 8, 160), torch.float32, 10)):
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
             torch.bfloat16, 5)):
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
    fa.BWD_ROUTE_LAUNCHES.update(wgmma=0, tf32x3=0)
    geglu.ROUTE_LAUNCHES.update(wgmma=0, tf32x3=0)


def check_routes(path, counts, wgmma, fma, bwd_wgmma=0, wide=0, tf32x3=0,
                 bwd_tf32x3=0, geglu_tf32x3=0):
    """K1's launches on a path split by route: every bf16 UNet attention
    (d = 64) took the wgmma route's d <= 256 kernel, every fp32 one the
    3xTF32 route, every bf16 VAE attention (d = 512) the wgmma route's
    wide kernel (`wide` of the route's launches), every fp32 VAE
    attention (d = 512) the FMA one; K4's: every bf16 backward the wgmma
    route, every fp32 one the 3xTF32 route; and K2's: every fp32
    feed-forward (`geglu_tf32x3`) the 3xTF32 route, every other one the
    bf16 wgmma route. Returns the path's counts with K1 split into its
    four kernels, K4 into its two routes and K2 into its two."""
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu
    k2 = counts["geglu_projection"]
    got = {"K1": dict(fa.ROUTE_LAUNCHES), "K1 wide": fa.WIDE_LAUNCHES,
           "K4": dict(fa.BWD_ROUTE_LAUNCHES),
           "K2": dict(geglu.ROUTE_LAUNCHES)}
    want = {"K1": {"wgmma": wgmma + wide, "tf32x3": tf32x3, "fma": fma},
            "K1 wide": wide,
            "K4": {"wgmma": bwd_wgmma, "tf32x3": bwd_tf32x3},
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
    as uint8 frames (F, H, W, 3) in memory: every start of `num_frames`
    consecutive frames, drawn by seed as VideoClipDataset draws them,
    normalised as it does; a frame's id is (0, its index)."""

    def __init__(self, frames, num_frames):
        self.frames = frames
        self.num_frames = num_frames
        self.starts = list(range(len(frames) - num_frames + 1))

    def __len__(self):
        return len(self.starts)

    def sample_batch_meta(self, batch_size, seed):
        import numpy as np
        from video_style_transfer_tpu_torch.data.video import _normalize
        idx = np.random.RandomState(seed).randint(0, len(self),
                                                  size=batch_size)
        f = self.num_frames
        clips = [_normalize(self.frames[self.starts[i]:self.starts[i] + f])
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
    checkpoint on disk."""
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
    report = {}
    reset_counters()
    t0 = time.perf_counter()
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
    return check_routes("serving", counts, len(modes) * 70 * STEPS,
                        len(modes) * NUM_FRAMES)


def image_path(artifacts):
    """The image path at full SDXL width: mode both with distinct content
    and style prompts, so 10 of 12 projections per block fold and the
    cross-attention k/v keep live LoRA branches, cached once."""
    from video_style_transfer_tpu_torch.cli import infer

    args = infer.build_parser().parse_args([
        "--prompt", "a dog in watercolor style", "--prompt_content",
        "a dog", "--prompt_style", "watercolor style", "--mode", "both",
        "--unziplora_name_or_path", artifacts, "--resolution",
        str(RESOLUTION), "--guidance_scale", "5", "--sampler", "dpm",
        "--num_inference_steps", str(IMAGE_STEPS), "--seeds", "0",
        "--device", "cuda"])
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
    return check_routes("image", counts, 70 * IMAGE_STEPS, 1)


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


def main():
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
        by_path = {"serving": main_path(artifacts, motion_checkpoint),
                   "stage2": stage2_counts,
                   "stage2_fp32": precision_counts,
                   "stage1": stage1_counts}
        section("serving")
        by_path["image"] = image_path(artifacts)
        torch.cuda.empty_cache()
        by_path["bf16_decode"] = vae_bf16_decode_path()
        section("image and bf16 decode")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_path["layer_norm_phase"] = {"layer_norm": ln_launches}
    main_paths = ("serving", "stage2", "image", "bf16_decode", "stage2_fp32",
                  "stage1")

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
                for r in ("wgmma", "tf32x3")}
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
                      "stage1": stage1,
                      "bf16_decode_s_per_frame":
                          by_path["bf16_decode"]["decode_s_per_frame"]}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
