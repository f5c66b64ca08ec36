"""K7: one-pass LayerNorm over the minor axis — CUDA kernel
(csrc/layer_norm.cu) and its plain PyTorch version.

Replaces the JAX package's ops/layer_norm.py Pallas kernel (`_kernel`).
``y = (x - mean) * rsqrt(var + eps) * scale + bias`` per row, with f32
statistics and an f32 affine, rounded once at the output. On the H100 it
is bound by device-memory bandwidth (one read and one write of the
activation); see the source for its design.

As in the JAX package, no model calls it: ``models/layers.py:layer_norm``
keeps the library call, and this module stands beside it with its tests
and its timings, for the decision whether to wire it in.

The backward differentiates the plain formula (the JAX `_ln_bwd` runs
``jax.vjp`` of `_reference`): the kernel has no backward kernel. A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version.
"""
from __future__ import annotations

import torch

from video_style_transfer_tpu_torch.ops import cuda_build

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 2048


def layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """The f32 formula of the JAX `_reference`: two-pass mean and
    (biased) variance, affine in f32, one rounding to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _check(x2d, scale, bias):
    if not (scale.is_cuda and bias.is_cuda
            and x2d.device == scale.device == bias.device):
        raise ValueError("layer_norm: x, scale, bias must be on one CUDA "
                         "device")
    if x2d.dtype not in _DTYPES:
        raise TypeError(f"layer_norm takes float32 or bfloat16 x, got "
                        f"{x2d.dtype}")
    if scale.dtype != bias.dtype or scale.dtype not in (x2d.dtype,
                                                        torch.float32):
        raise TypeError(f"layer_norm takes scale and bias both in x's "
                        f"dtype ({x2d.dtype}) or both in float32, got "
                        f"{scale.dtype} and {bias.dtype}")
    m, c = x2d.shape
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm shapes: x {tuple(x2d.shape)} scale "
                         f"{tuple(scale.shape)} bias {tuple(bias.shape)}")
    vec = 16 // x2d.element_size()
    if m == 0 or c % vec or c > MAX_CHANNELS:
        raise ValueError(f"layer_norm kernel takes M >= 1 rows and C a "
                         f"multiple of {vec} up to {MAX_CHANNELS} for "
                         f"{x2d.dtype}, got ({m}, {c})")
    if m >= 2 ** 34:
        raise ValueError(f"layer_norm: {m} rows exceed the launch grid")


def layer_norm_fwd(x2d, scale, bias, eps: float = 1e-5):
    """x2d (M, C), scale and bias (C,) -> (M, C) in x's dtype (K7; no
    autograd)."""
    if not x2d.is_cuda:
        return layer_norm_reference(x2d, scale, bias, eps)
    _check(x2d, scale, bias)
    x2d = x2d.contiguous()
    # the kernel reads the affine in the dtype it is held in: no cast here
    scale, bias = scale.detach().contiguous(), bias.detach().contiguous()
    out = torch.empty_like(x2d)
    for name, t in (("x", x2d), ("scale", scale), ("bias", bias),
                    ("y", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm: {name} is not 16-byte aligned")
    lib = cuda_build.library()
    with torch.cuda.device(x2d.device):
        err = lib.vst_layer_norm_fwd(
            _DTYPES[x2d.dtype], _DTYPES[scale.dtype], x2d.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), x2d.shape[0],
            x2d.shape[1], float(eps), cuda_build.stream_of(x2d))
    cuda_build.check_launch("layer_norm", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        ctx.save_for_backward(x2d, scale, bias)
        ctx.eps = eps
        return layer_norm_fwd(x2d, scale, bias, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = layer_norm_reference(*ins, ctx.eps)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wanted, grad))
        return tuple(next(got) if n else None for n in need) + (None,)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """LayerNorm over the minor axis with scale and bias, one pass over
    x; differentiable. x: (..., C)."""
    c = x.shape[-1]
    return _LayerNorm.apply(x.reshape(-1, c), scale, bias,
                            float(eps)).reshape(x.shape)
