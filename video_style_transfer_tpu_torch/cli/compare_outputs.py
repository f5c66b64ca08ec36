"""Output-quality comparison (the JAX package's cli/compare_outputs.py).

PSNR and SSIM (numpy) are always reported; ``--lpips WEIGHTS`` (a .pth
or .safetensors holding torchvision's VGG16 ``features.*`` weights merged
with the lpips package's ``lin*.model.1.weight`` heads) adds per-frame
LPIPS (models/lpips.py) on ``--device`` (cuda by default; cuda without a
card is an error). Takes image files or videos.

    python -m video_style_transfer_tpu_torch.cli.compare_outputs \\
        --ours out/both_seed0.png --reference ref/both_seed0.png \\
        --lpips lpips_vgg16.safetensors --json_out report.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def load_frames(path: str) -> np.ndarray:
    """Image or video path -> (N, H, W, 3) uint8."""
    if path.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))[None]
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames in {path}")
    return np.stack(frames)


# equal frames would give PSNR = inf, which json.dumps writes as the
# non-RFC-8259 token `Infinity`: a finite ceiling instead
PSNR_MAX = 100.0


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return PSNR_MAX
    return float(min(10 * np.log10(255.0 ** 2 / mse), PSNR_MAX))


def ssim(a: np.ndarray, b: np.ndarray, *, c1=(0.01 * 255) ** 2,
         c2=(0.03 * 255) ** 2, win: int = 8) -> float:
    """Windowed SSIM: a uniform window of win x win, each channel's
    blocks, the mean over all of them."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)

    def blocks(x):
        h, w = x.shape[:2]
        hh, ww = h // win * win, w // win * win
        x = x[:hh, :ww]
        return x.reshape(hh // win, win, ww // win, win, -1) \
                .transpose(0, 2, 4, 1, 3).reshape(-1, win * win)

    pa, pb = blocks(a), blocks(b)
    mu_a, mu_b = pa.mean(-1), pb.mean(-1)
    va, vb = pa.var(-1), pb.var(-1)
    cov = ((pa - mu_a[:, None]) * (pb - mu_b[:, None])).mean(-1)
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return float(s.mean())


def load_lpips_weights(path: str, device="cpu"):
    """Merged VGG16 + heads LPIPS weights (.pth or .safetensors) -> the
    models/lpips.py params on `device`."""
    import torch

    from video_style_transfer_tpu_torch.models.lpips import convert_lpips
    if path.endswith(".safetensors"):
        from video_style_transfer_tpu_torch.utils.safetensors_io import (
            load_numpy)
        sd = load_numpy(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k: v.float().numpy() for k, v in raw.items()}
    return convert_lpips(sd, device=device)


def lpips_frames(params, a: np.ndarray, b: np.ndarray, device):
    """Per-frame LPIPS of two (N, H, W, 3) uint8 stacks, a frame at a
    time, on `device`."""
    import torch

    from video_style_transfer_tpu_torch.models.lpips import lpips_distance

    def unit(x):
        return (torch.from_numpy(np.array(x)).to(device).float()
                / 127.5 - 1.0)[None]

    with torch.inference_mode():
        return np.array([float(lpips_distance(params, unit(x), unit(y))[0])
                         for x, y in zip(a, b)])


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ours", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--lpips", default=None, metavar="WEIGHTS",
                   help="VGG16 + heads LPIPS weight file; adds per-frame "
                        "LPIPS to the report")
    p.add_argument("--json_out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where LPIPS runs: cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    a = load_frames(args.ours)
    b = load_frames(args.reference)
    n = min(len(a), len(b))

    lpips_vals = None
    if args.lpips:
        from video_style_transfer_tpu_torch.cli.common import resolve_device
        device = resolve_device(args.device)
        lpips_vals = lpips_frames(load_lpips_weights(args.lpips, device),
                                  a[:n], b[:n], device)

    per_frame = []
    for i in range(n):
        ai, bi = a[i], b[i]
        if ai.shape != bi.shape:
            raise SystemExit(f"shape mismatch at frame {i}: "
                             f"{ai.shape} vs {bi.shape}")
        row = {"frame": i, "psnr": psnr(ai, bi), "ssim": ssim(ai, bi)}
        if lpips_vals is not None:
            row["lpips"] = float(lpips_vals[i])
        per_frame.append(row)
    report = {
        "frames": n,
        "psnr_mean": float(np.mean([f["psnr"] for f in per_frame])),
        "ssim_mean": float(np.mean([f["ssim"] for f in per_frame])),
        "per_frame": per_frame,
    }
    if lpips_vals is not None:
        report["lpips_mean"] = float(np.mean(lpips_vals))
        report["lpips_max"] = float(np.max(lpips_vals))
    print(json.dumps({k: v for k, v in report.items()
                      if k != "per_frame"}))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
