"""Where the time of one denoise step goes, on the GPU.

Builds the full-width SDXL + AnimateDiff-XL UNet with seeded random
weights (as ``cli.infer_video`` does without a checkpoint), runs one
warm-up CFG denoise call, then traces one more with ``torch.profiler``
and prints, as one JSON line: the step's host seconds (ending in a
synchronise), the device kernels' summed time by category (the port's
three kernels, GEMMs, convolutions, everything else) with launch counts,
the device's idle share between the first and the last kernel, and the
slowest kernel names.

    python -m video_style_transfer_tpu_torch.cli.profile_step \\
        [--num_frames 16] [--resolution 1024]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

# first match wins: cuDNN's convolutions are implicit GEMMs by name
CATEGORIES = (
    ("K1 flash_attention_fwd", ("flash_fwd_kernel", "flash_fwd_mma_kernel")),
    ("K2 geglu_projection", ("geglu_bf16_kernel", "geglu_f32_kernel")),
    ("K3 temporal_attention", ("ta_fwd_kernel",)),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "winograd")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None):
    from video_style_transfer_tpu_torch.cli import common
    from video_style_transfer_tpu_torch.pipelines.sampling import (
        make_cfg_denoiser)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    dev = common.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with torch.inference_mode():
        bundle = common.load_models(None, motion=True, dtype=torch.bfloat16,
                                    device=dev)
        res, f = args.resolution, args.num_frames
        uncond = common.negative_conditioning(
            bundle, common.DEFAULT_NEGATIVE_PROMPT, height=res, width=res)
        cond = common.make_conditioning(bundle, "a horse", height=res,
                                        width=res)
        eps_fn = make_cfg_denoiser(bundle.unet, bundle.unet_cfg, uncond,
                                   cond, cfg_scale=7.5, num_frames=f,
                                   dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(f, res // 8, res // 8, 4, generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)
        t = torch.tensor(958.0, device=dev)
        eps_fn(x, t)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eps_fn(x, t)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0

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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "num_frames": f, "resolution": res, "cfg_rows": 2 * f,
        "step_host_s": step_s,
        "kernel_ms_total": sum(v[0] for v in by_cat.values()),
        "device_busy_ms": busy / 1e3, "device_window_ms": window / 1e3,
        "device_idle_share": 1.0 - busy / window,
        "by_category": {k: {"ms": v[0], "launches": v[1]}
                        for k, v in sorted(by_cat.items(),
                                           key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": k, "ms": v[0], "launches": v[1]}
                        for k, v in top]}))


if __name__ == "__main__":
    main()
