"""LPIPS perceptual distance, VGG16 variant (the JAX package's
models/lpips.py).

The quality gate of the parity runbook is per-frame LPIPS <= 0.02 against
the reference's outputs. This is the richzhang LPIPS-VGG metric as plain
functions over a params dict, with a converter for the standard weight
files:

- the VGG16 backbone in torchvision's names, ``features.{idx}.weight /
  bias`` (conv indices 0,2 | 5,7 | 10,12,14 | 17,19,21 | 24,26,28);
- the linear heads in the lpips package's names,
  ``lin{i}.model.1.weight`` (1x1 convs, one per feature slice).

Math (LPIPS v0.1): inputs in [-1, 1] -> channel shift and scale -> VGG
features at relu1_2/2_2/3_3/4_3/5_3 -> unit-normalised along channels ->
squared difference -> 1x1 linear head -> spatial mean -> sum over the
slices. The convolutions are cuDNN's on the card (no kernel of the port's
own); the params keep torchvision's OIHW weights.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from video_style_transfer_tpu_torch.models import layers

# channel statistics of the LPIPS ScalingLayer (lpips/lpips.py v0.1)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision VGG16 'features' conv indices of each LPIPS slice
VGG16_SLICE_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21),
                        (24, 26, 28))
VGG16_CHANNELS = (64, 128, 256, 512, 512)


def init_lpips(ini, *, channels: Sequence[int] = VGG16_CHANNELS,
               convs_per_slice: Sequence[int] = (2, 2, 3, 3, 3),
               in_channels: int = 3):
    """Seeded LPIPS params (`ini`: a models.layers.Init); the heads are
    U(0, 1), non-negative like the released ones."""
    slices = []
    c_in = in_channels
    for c_out, n_convs in zip(channels, convs_per_slice):
        convs = []
        for _ in range(n_convs):
            convs.append(layers.init_conv(ini, c_in, c_out, 3))
            c_in = c_out
        slices.append(convs)
    lins = [{"weight": ini.uniform((1, c), 0.5) + 0.5} for c in channels]
    return {"slices": slices, "lins": lins}


def convert_lpips(sd: Dict[str, np.ndarray], dtype=torch.float32,
                  device="cpu"):
    """torchvision VGG16 ``features.*`` and lpips ``lin*.model.1.weight``
    (one merged state dict, numpy or torch values) -> params: conv
    weights as they are (OIHW), each head's (1, C, 1, 1) as (1, C)."""
    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    slices = [[{"weight": t(sd[f"features.{i}.weight"]),
                "bias": t(sd[f"features.{i}.bias"])} for i in idxs]
              for idxs in VGG16_SLICE_CONV_IDX]
    lins = []
    for i in range(len(VGG16_SLICE_CONV_IDX)):
        w = t(sd[f"lin{i}.model.1.weight"])
        lins.append({"weight": w.reshape(1, w.shape[1])})
    return {"slices": slices, "lins": lins}


def _vgg_features(params, x):
    """x: (N, 3, H, W), shifted and scaled. One map per slice (after the
    ReLU, before the pool)."""
    feats = []
    h = x
    for s, convs in enumerate(params["slices"]):
        if s > 0:
            h = F.max_pool2d(h, 2)
        for conv in convs:
            h = F.relu(F.conv2d(h, conv["weight"].to(h.dtype),
                                conv["bias"].to(h.dtype),
                                padding=conv["weight"].shape[-1] // 2))
        feats.append(h)
    return feats


def lpips_distance(params, x, y):
    """x, y: (N, H, W, 3) in [-1, 1]. Returns (N,) LPIPS distances."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)

    def prep(z):
        return ((z - shift) / scale).permute(0, 3, 1, 2)

    fx = _vgg_features(params, prep(x))
    fy = _vgg_features(params, prep(y))
    total = 0.0
    for fxi, fyi, lin in zip(fx, fy, params["lins"]):
        nx = fxi * torch.rsqrt((fxi * fxi).sum(1, keepdim=True) + 1e-10)
        ny = fyi * torch.rsqrt((fyi * fyi).sum(1, keepdim=True) + 1e-10)
        # the heads as stored: the released ones are non-negative
        d = (nx - ny) ** 2
        res = torch.einsum("nchw,c->nhw", d, lin["weight"][0].to(d.dtype))
        total = total + res.mean(dim=(1, 2))
    return total
