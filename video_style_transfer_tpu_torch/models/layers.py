"""Primitive layers as plain functions over dict params.

Activations stay NHWC at every public function, as in the JAX package;
weights are stored in PyTorch's layouts: linear ``weight`` (out, in),
conv ``weight`` OIHW, norm ``weight``/``bias``. Convolutions run on an
NCHW view of the NHWC tensor (``permute``), which is the ``channels_last``
memory format cuDNN prefers, so no copy is made.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from video_style_transfer_tpu_torch.ops import group_norm as gn_ops
from video_style_transfer_tpu_torch.ops import layer_norm as ln_ops


class Init:
    """Seeded initialiser: every tensor is drawn from one
    ``torch.Generator`` on ``device`` (torch-default bounds, as the JAX
    package's ``_kaiming_uniform``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)))."""

    def __init__(self, seed: int, device="cpu", dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def uniform(self, shape, bound: float):
        t = torch.empty(shape, device=self.device, dtype=torch.float32)
        t.uniform_(-bound, bound, generator=self.gen)
        return t.to(self.dtype)

    def normal(self, shape, std: float, dtype=None):
        t = torch.empty(shape, device=self.device, dtype=torch.float32)
        t.normal_(0.0, std, generator=self.gen)
        return t.to(self.dtype if dtype is None else dtype)

    def ones(self, n: int):
        return torch.ones(n, device=self.device, dtype=self.dtype)

    def zeros(self, n: int):
        return torch.zeros(n, device=self.device, dtype=self.dtype)


class MetaInit(Init):
    """Shape-only initialiser: every tensor lives on the ``meta`` device
    (shape and dtype, no storage), so a full-width parameter tree can be
    walked for its key names and shapes without allocating it."""

    def __init__(self, dtype=torch.float32):
        self.device = torch.device("meta")
        self.dtype = dtype
        self.gen = None

    def uniform(self, shape, bound: float):
        return torch.empty(shape, device=self.device, dtype=self.dtype)

    def normal(self, shape, std: float, dtype=None):
        return torch.empty(shape, device=self.device,
                           dtype=self.dtype if dtype is None else dtype)


def remat(fn, *args):
    """fn(*args) with its activations recomputed in the backward instead
    of stored (``jax.checkpoint``'s counterpart). Nothing inside draws
    random numbers, so the RNG state is not stashed."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def init_linear(ini: Init, in_features: int, out_features: int, *,
                bias: bool = True):
    bound = 1.0 / math.sqrt(in_features)
    p = {"weight": ini.uniform((out_features, in_features), bound)}
    if bias:
        p["bias"] = ini.uniform((out_features,), bound)
    return p


def linear(p, x):
    return F.linear(x, p["weight"].to(x.dtype),
                    None if "bias" not in p else p["bias"].to(x.dtype))


def init_conv(ini: Init, in_channels: int, out_channels: int,
              kernel_size: int, *, bias: bool = True):
    bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
    p = {"weight": ini.uniform(
        (out_channels, in_channels, kernel_size, kernel_size), bound)}
    if bias:
        p["bias"] = ini.uniform((out_channels,), bound)
    return p


def conv2d(p, x, *, stride: int = 1, padding="SAME"):
    """x: (..., H, W, C) NHWC; leading dims beyond 4 are flattened. The
    JAX package's strip-batched 3x3 conv is a TPU workaround for XLA's
    space-to-batch lowering; here every conv is one cuDNN call."""
    lead = x.shape[:-3]
    x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
    w = p["weight"].to(x.dtype)
    if padding == "SAME":
        pad = w.shape[-1] // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(padding)
    b = None if "bias" not in p else p["bias"].to(x.dtype)
    y = F.conv2d(x4.permute(0, 3, 1, 2), w, b, stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def init_norm(ini: Init, num_channels: int):
    return {"weight": ini.ones(num_channels), "bias": ini.zeros(num_channels)}


def group_norm(p, x, *, num_groups: int, eps: float = 1e-5,
               silu: bool = False):
    """GroupNorm over channels-last input (B, ..., C): each group of
    C/num_groups channels is normalised jointly with all positions, with
    fp32 statistics (torch.nn.GroupNorm semantics), then SiLU where
    `silu`, through ops/group_norm.py: the kernels on the card, the plain
    formula on the CPU. The output is rounded once to x's dtype, and
    with `silu` that value goes through SiLU as ``silu(group_norm(...))``
    would take it."""
    return gn_ops.group_norm(x, p["weight"], p["bias"], num_groups, eps=eps,
                             silu=silu)


def layer_norm(p, x, *, eps: float = 1e-5):
    """LayerNorm over the minor axis through K7's module
    (ops/layer_norm.py): the kernel on the card, the JAX package's f32
    formula on the CPU. fp32 statistics and an fp32 affine, the weight
    and bias applied as they are held (the JAX formula's
    ``astype(float32)``), rounded once at the output."""
    return ln_ops.layer_norm(x, p["weight"], p["bias"], eps=eps)


def silu(x):
    return F.silu(x)


def gelu(x):
    return F.gelu(x)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)
