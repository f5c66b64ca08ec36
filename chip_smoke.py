#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   video_style_transfer_tpu_torch/csrc/ and prints the build time.
2. Holds each kernel against its plain PyTorch version at the serving
   path's shapes, in bf16 and in fp32 (TF32 off), and times the kernel,
   the plain version and, where one PyTorch call computes the same
   function, that call (the yardstick only; the port never calls it).
3. Holds the tiny pipeline on the card against the same pipeline on the
   CPU (the plain versions), then drives the serving path through
   ``cli.infer_video.generate`` at full SDXL + AnimateDiff-XL width and
   depth (seeded random weights, 16 frames, 1024^2, CFG 7.5, 2 steps,
   --modes base, bf16 UNet, fp32 VAE decode), with every kernel's launch
   counter set to 0 just before and read just after.
4. Prints one JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}. Any failure exits non-zero before that.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores (the fp32 kernels run with TF32 off), HBM bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

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

NUM_FRAMES, RESOLUTION, STEPS = 16, 1024, 2


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


def check_phase(name, kernel, plain, library, flops, nbytes, dtype_name,
                iters):
    """Compare kernel vs plain, time all three; returns the phase dict."""
    import torch
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    atol, rtol = TOL[dtype_name]
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(outs, refs))
    excess = max(((o.float() - r.float()).abs()
                  - rtol * r.float().abs()).max().item()
                 for o, r in zip(outs, refs))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    del out, ref, outs, refs
    ms = time_ms(kernel, iters)
    plain_ms = time_ms(plain, max(1, iters // 4))
    library_ms = None if library is None else time_ms(library,
                                                      max(1, iters // 4))
    bound_ms, bound_by = bound(flops, nbytes, dtype_name)
    print(f"  {name}: max_abs_err {err:.3e} (limit {atol:g} + "
          f"{rtol:g}*|plain|, excess {excess:.3e}) kernel {ms:.4f} ms"
          f" plain {plain_ms:.4f} ms library "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    if not finite:
        fail(f"{name}: kernel output is not finite")
    if not excess <= atol:
        fail(f"{name}: error exceeds {atol} + {rtol}*|plain| by "
             f"{excess - atol}")
    torch.cuda.empty_cache()
    return {"phase": name, "dtype": dtype_name, "max_abs_err": err,
            "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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

    # K1: UNet level-2 self-attention (bf16), VAE mid-block (fp32, d=512;
    # S=4096 rather than the 1024^2 path's 16384, where the plain
    # version's f32 logits alone would be 1 GB per head and batch)
    for tag, (b, s, h, d), dt, iters in (
            ("unet_l2 (32,1024,20x64)", (32, 1024, 20, 64),
             torch.bfloat16, 20),
            ("vae_mid (1,4096,1x512)", (1, 4096, 1, 512), torch.float32, 5)):
        qkv = randn(b, s, 3 * h * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        es = qkv.element_size()
        phases["flash_attention_fwd"].append(check_phase(
            f"K1 {tag} {str(dt)[6:]}",
            lambda: fa.flash_attention_fwd(q, k, v),
            lambda: fa.flash_attention_plain(q, k, v, d ** -0.5),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            flops=4 * b * h * s * s * d,
            nbytes=4 * b * s * h * d * es + b * h * s * 4,
            dtype_name=str(dt)[6:], iters=iters))
        del qkv, q, k, v, qt, kt, vt

    # K2: spatial level-2 FF and motion level-0 FF (bf16), level-2 fp32
    for tag, (m, c), dt, iters in (
            ("spatial_l2 (32768,1280->5120)", (32768, 1280),
             torch.bfloat16, 10),
            ("motion_l0 (524288,320->1280)", (524288, 320),
             torch.bfloat16, 5),
            ("spatial_l2 (32768,1280->5120)", (32768, 1280),
             torch.float32, 3)):
        inner = 4 * c
        x = randn(m, c, dtype=dt)
        w = randn(2 * inner, c, dtype=dt, scale=c ** -0.5)
        bias = randn(2 * inner, dtype=dt, scale=0.1)
        gate = geglu._default_gate_for(dt)
        es = x.element_size()
        phases["geglu_projection"].append(check_phase(
            f"K2 {tag} {str(dt)[6:]} gate {gate}",
            lambda: geglu.geglu_projection(x, w, bias),
            lambda: geglu.geglu_plain(x, w, bias, gate),
            None,
            flops=4 * m * c * inner,
            nbytes=(m * c + 2 * inner * c + 2 * inner + m * inner) * es,
            dtype_name=str(dt)[6:], iters=iters))
        del x, w, bias

    # K3: motion level 0 (F=16, N=32768, 8 heads x d=40)
    for dt, iters in ((torch.bfloat16, 20), (torch.float32, 10)):
        f, n, h, d = 16, 32768, 8, 40
        qkv = randn(f, n, 3 * h * d, dtype=dt)
        q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1))
        qt, kt, vt = (t.permute(1, 2, 0, 3) for t in (q, k, v))  # (N,H,F,d)
        es = qkv.element_size()
        phases["temporal_attention"].append(check_phase(
            f"K3 motion_l0 (16,32768,8x40) {str(dt)[6:]}",
            lambda: ta.temporal_attention(q, k, v),
            lambda: ta.temporal_attention_plain(q, k, v, d ** -0.5),
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            flops=4 * f * f * n * h * d,
            nbytes=4 * f * n * h * d * es,
            dtype_name=str(dt)[6:], iters=iters))
        del qkv, q, k, v, qt, kt, vt
    return phases


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


def main_path():
    import torch
    from video_style_transfer_tpu_torch.cli import infer_video
    from video_style_transfer_tpu_torch.ops import flash_attention as fa
    from video_style_transfer_tpu_torch.ops import geglu
    from video_style_transfer_tpu_torch.ops import temporal_attention as ta

    args = infer_video.build_parser().parse_args([
        "--prompt", "a horse galloping through a snowy forest",
        "--modes", "base", "--num_frames", str(NUM_FRAMES),
        "--resolution", str(RESOLUTION), "--num_inference_steps", str(STEPS),
        "--guidance_scale", "7.5", "--device", "cuda", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    report = {}
    fa.LAUNCHES = geglu.LAUNCHES = ta.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = infer_video.generate(args, report)
    total = time.perf_counter() - t0
    counts = {"flash_attention_fwd": fa.LAUNCHES,
              "geglu_projection": geglu.LAUNCHES,
              "temporal_attention": ta.LAUNCHES}
    rep = report["base"]
    print(f"main path: weight init {report['weight_init_s']:.3f} s, text "
          f"encode {rep['text_encode_s']:.3f} s, denoise steps "
          f"{', '.join(f'{s:.3f}' for s in rep['denoise_step_s'])} s "
          f"(step 1 includes the cross-attention k/v precompute), decode "
          f"{rep['decode_s']:.3f} s ({NUM_FRAMES} frames), total "
          f"{total:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    # per denoise step: 70 spatial transformer blocks (one self-attention
    # and one feed-forward each) and 15 motion modules (two temporal
    # attentions and one feed-forward each); the VAE mid-block attention
    # once per decoded frame
    expected = {"flash_attention_fwd": 70 * STEPS + NUM_FRAMES,
                "geglu_projection": 85 * STEPS,
                "temporal_attention": 30 * STEPS}
    print(f"launches on the main path: {counts} (expected {expected})",
          flush=True)
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if n != expected[name]:
            fail(f"kernel {name} launched {n} times, expected "
                 f"{expected[name]}")
    video = outs["base"]
    shape = (NUM_FRAMES, RESOLUTION, RESOLUTION, 3)
    if video.shape != shape or str(video.dtype) != "uint8":
        fail(f"frames {video.shape} {video.dtype}, expected {shape} uint8")
    if float(video.std()) == 0.0:
        fail("frames are constant")
    print(f"frames: {video.shape} uint8, finite before the cast, mean "
          f"{float(video.mean()):.2f} std {float(video.std()):.2f}",
          flush=True)
    return counts


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
    t0 = time.perf_counter()
    cuda_build.library()
    built = cuda_build.build_info
    log = built["log"].splitlines()
    spills = [ln.strip() for ln in log
              if "spill" in ln and " 0 bytes spill stores" not in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({'compiled' if built['built'] else 'cached'}; nvcc "
          f"{built['seconds'] or 0:.1f} s), "
          f"{sum('Used' in ln for ln in log)} kernels, "
          f"{len(spills)} with register spills", flush=True)
    for ln in spills:
        print(f"  {ln}", flush=True)

    print("kernels vs plain versions (the VAE mid-block attention is "
          "checked at S=4096, not the path's 16384, where the plain "
          "version's f32 logits alone would be 1 GB):", flush=True)
    phases = kernel_phases()
    small_reference()
    counts = main_path()

    sources = {
        "flash_attention_fwd": (
            "video_style_transfer_tpu_torch/csrc/flash_attention.cu",
            "video_style_transfer_tpu/ops/flash_attention.py:253"),
        "geglu_projection": (
            "video_style_transfer_tpu_torch/csrc/geglu.cu",
            "video_style_transfer_tpu/ops/geglu.py:100"),
        "temporal_attention": (
            "video_style_transfer_tpu_torch/csrc/temporal_attention.cu",
            "video_style_transfer_tpu/ops/temporal_attention.py:37"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        first = phases[name][0]  # the main path's principal shape
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": first["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "phases": phases[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
