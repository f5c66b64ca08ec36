"""K7: one-pass LayerNorm over the minor axis — CUDA kernel
(csrc/layer_norm.cu) and its plain PyTorch version.

Replaces the JAX package's ops/layer_norm.py Pallas kernel (`_kernel`).
``y = (x - mean) * rsqrt(var + eps) * scale + bias`` per row, with f32
statistics and an f32 affine, rounded once at the output. On the H100 it
is bound by device-memory bandwidth (one read and one write of the
activation); see the source for its design.

Every LayerNorm of the port's models comes here
(``models/layers.py:layer_norm``). The JAX package keeps its models on
the XLA formula, a choice for the TPU, where XLA fuses the statistics
into the producer; in eager PyTorch on the H100 the library call is a
kernel of its own too, and slower than this one.

A CPU tensor takes the plain version (the JAX `_reference` formula) and
its autograd. A CUDA tensor launches the kernel or raises:
- with no gradient to record (serving runs under
  ``torch.inference_mode``), the bare launcher runs: one layout check,
  cached by layout, one allocation and one C call with the arguments
  packed in one struct;
- with one, an autograd Function's forward also has the kernel write
  each row's f32 mean and rstd, and its backward reads them: dx from
  aten's ``native_layer_norm_backward`` (asked for dx alone), and where
  the parameters are trained (stage 2's motion modules) dscale and dbias
  from kernels of this module (`layer_norm_affine_grads`: f32 column
  sums; aten's own bf16 ones at stage 2's 131072 rows fall outside the
  backward limits against the plain formula's autograd). The JAX package
  computes this backward in XLA (`_ln_bwd`: ``jax.vjp`` of `_reference`),
  not in a Pallas kernel.
The affine goes to the kernel as it is held where that is x's dtype or
f32; otherwise it is cast to f32, as the formula's ``astype(float32)``
does.
"""
from __future__ import annotations

import struct

import torch

from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.utils import tracing

# launches of the CUDA kernel in this process (the plain version and
# refused calls do not count)
LAUNCHES = 0
# calls of the dscale / dbias kernels (csrc/layer_norm.cu:
# layer_norm_affine_grad_kernel and its finish kernel, one call both)
AFFINE_LAUNCHES = 0
# copies of x the wrapper made because x was not contiguous or not 16-byte
# aligned (the models' LayerNorm inputs are both: chip_smoke.py holds
# this at 0 on every path)
COPIES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 2048
# one K7 call's arguments, packed for its C entry point
# (csrc/layer_norm.cu: LayerNormCall) in two parts: the x, scale, bias,
# y, mean and rstd pointers (0 and 0 without statistics) and the stream;
# the layout (M, C, the device, x's and the affine's dtypes, rows a
# block, eps), packed once a layout
_POINTERS = struct.Struct("<7Q")
_LAYOUT = struct.Struct("<q5if")
# the dscale / dbias kernels' (LayerNormAffineGradCall): the x, g, mean,
# rstd, partial-sum and output pointers and the stream; M, C, the device,
# x's dtype, the output's, rows a warp and blocks (of 8 warps)
_AFFINE_CALL = struct.Struct("<7Qq6i")


def layer_norm_reference(x, scale, bias, eps: float = 1e-5):
    """The f32 formula of the JAX `_reference`: two-pass mean and
    (biased) variance, affine in f32, one rounding to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_stats_reference(x, eps: float = 1e-5):
    """Each row's f32 mean and rstd = rsqrt(var + eps) by the plain
    formula, as (M, 1) for x (..., C): what the kernel writes for the
    backward."""
    xf = x.reshape(-1, x.shape[-1]).float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    return mean, torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)


def rows_per_block(m: int, sms: int) -> int:
    """Rows (one warp each) of a K7 block for M rows on a card of `sms`
    SMs: 8 where that still gives every SM a block, else the most that
    do, down to 1 (the text encoders' 77-154 rows)."""
    for rows in (8, 4, 2):
        if -(-m // rows) >= sms:
            return rows
    return 1


# layouts K7 has accepted, by the dtypes, devices, shapes, contiguity and
# pointer alignment of x, scale and bias and by eps: (the packed layout
# part of the call, x's device, whether x needs a contiguous copy, the
# dtype the affine is cast or copied to, or None)
_ACCEPTED = {}
_fwd = None  # the bound C entry point, once the library is loaded


def _key(x, scale, bias, eps):
    """x, scale and bias's key in `_ACCEPTED`: each tensor's alignment
    apart, since `_layout` decides a copy of x and one of the affine
    apart."""
    return (x.dtype, scale.dtype, bias.dtype,
            x.get_device(), scale.get_device(), bias.get_device(),
            x.shape, scale.shape, bias.shape, x.is_contiguous(),
            scale.is_contiguous(), bias.is_contiguous(), x.data_ptr() & 15,
            scale.data_ptr() & 15, bias.data_ptr() & 15, eps)


def _check(x, scale, bias, eps):
    """Raises on (x, scale, bias) that K7 does not take; returns their
    entry in `_ACCEPTED`. A layout accepted once is found again after one
    dict lookup."""
    key = _key(x, scale, bias, eps)
    entry = _ACCEPTED.get(key)
    if entry is None:
        entry = _layout(x, scale, bias, eps)
        if len(_ACCEPTED) >= 4096:
            _ACCEPTED.clear()
        _ACCEPTED[key] = entry
    return entry


def _layout(x, scale, bias, eps):
    """Raises on (x, scale, bias) that K7 does not take; else their entry
    in `_ACCEPTED`."""
    if not (x.is_cuda and scale.is_cuda and bias.is_cuda
            and x.device == scale.device == bias.device):
        raise ValueError("layer_norm: x, scale, bias must be on one CUDA "
                         "device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if not (scale.is_floating_point() and bias.is_floating_point()):
        raise TypeError(f"layer_norm takes a floating scale and bias, got "
                        f"{scale.dtype} and {bias.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm shapes: x {tuple(x.shape)} scale "
                         f"{tuple(scale.shape)} bias {tuple(bias.shape)}")
    m = x.numel() // c if c else 0
    vec = 16 // x.element_size()
    if m == 0 or c % vec or c > MAX_CHANNELS:
        raise ValueError(f"layer_norm kernel takes M >= 1 rows and C a "
                         f"multiple of {vec} up to {MAX_CHANNELS} for "
                         f"{x.dtype}, got ({m}, {c})")
    if m >= 2 ** 34:
        raise ValueError(f"layer_norm: {m} rows exceed the launch grid")
    # the affine as it is held where that is x's dtype or f32, both in one
    cast = not (scale.dtype == bias.dtype
                and scale.dtype in (x.dtype, torch.float32))
    affine = torch.float32 if cast else scale.dtype
    prepare = cast or not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                              for t in (scale, bias))
    copy = not x.is_contiguous() or x.data_ptr() % 16 != 0
    dev = x.get_device()
    rows = rows_per_block(m, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return (_LAYOUT.pack(m, c, dev, _DTYPES[x.dtype], _DTYPES[affine], rows,
                         eps), dev, copy, affine if prepare else None)


def _bind():
    global _fwd
    _fwd = cuda_build.library().vst_layer_norm_fwd
    return _fwd


def _launch(x, scale, bias, entry, stats=False):
    """K7 on checked, contiguous, aligned (x, scale, bias): y like x, and
    with `stats` each row's f32 mean and rstd as (M, 1)."""
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = torch.empty((2, x.numel() // x.shape[-1], 1),
                                 dtype=torch.float32, device=x.device)
    err = (_fwd or _bind())(
        _POINTERS.pack(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                       y.data_ptr(), 0 if mean is None else mean.data_ptr(),
                       0 if rstd is None else rstd.data_ptr(),
                       cuda_build.stream_of(x)) + entry[0])
    cuda_build.check_launch("layer_norm", err)
    global LAUNCHES
    LAUNCHES += 1
    return y, mean, rstd


def _prepared(x, scale, bias, entry):
    """(x, scale, bias) ready for `_launch`: a contiguous, aligned copy
    of x where it is not one; the affine cast to f32 where it is held in
    neither x's dtype nor f32, or copied where it is not contiguous and
    aligned."""
    _, _, copy, affine = entry
    if copy:
        x = x.clone(memory_format=torch.contiguous_format)
        global COPIES
        COPIES += 1
    if affine is not None:
        scale = scale.to(affine, copy=True)
        bias = bias.to(affine, copy=True)
    return x, scale, bias


def layer_norm_fwd(x, scale, bias, eps: float = 1e-5, *, stats=False):
    """x (..., C), scale and bias (C,) -> y (..., C) in x's dtype (K7; no
    autograd). stats: also each row's f32 mean and rstd, (M, 1) each."""
    if not x.is_cuda:
        y = layer_norm_reference(x, scale, bias, eps)
        return (y, *layer_norm_stats_reference(x, eps)) if stats else y
    entry = _check(x, scale, bias, eps)
    out = _launch(*_prepared(x, scale, bias, entry), entry, stats=stats)
    return out if stats else out[0]


def layer_norm_affine_grads_plain(g2d, x2d, mean, rstd):
    """dscale and dbias as f32 sums over the rows, (2, C): of g * (x -
    mean) * rstd and of g."""
    gf = g2d.float()
    return torch.stack([(gf * ((x2d.float() - mean) * rstd)).sum(0),
                        gf.sum(0)])


def affine_rows_per_warp(m: int, sms: int) -> int:
    """Rows a warp of the dscale / dbias kernel sums: enough that the grid
    is about two blocks of 8 warps an SM (each block writes one row of
    partial sums)."""
    return -(-m // (16 * sms))


def layer_norm_affine_grads(g2d, x2d, mean, rstd, dtype=torch.float32):
    """dscale and dbias of a LayerNorm as (2, C) of `dtype` (f32 or
    bf16): g2d, x2d (M, C) contiguous in one dtype, mean and rstd the
    forward's (M, 1) f32. On the card one call launches two kernels: each
    block writes its rows' f32 sums, then each column's are summed in
    float64 and rounded once to `dtype`; a CPU tensor takes the plain
    version."""
    if not x2d.is_cuda:
        return layer_norm_affine_grads_plain(g2d, x2d, mean, rstd).to(dtype)
    m, c = x2d.shape
    if not (g2d.is_cuda and x2d.device == g2d.device == mean.device
            == rstd.device):
        raise ValueError("layer_norm_affine_grads: g, x, mean, rstd must "
                         "be on one CUDA device")
    if x2d.dtype not in _DTYPES or g2d.dtype != x2d.dtype or not (
            mean.dtype == rstd.dtype == torch.float32) or \
            dtype not in _DTYPES:
        raise TypeError(f"layer_norm_affine_grads takes float32 or "
                        f"bfloat16 g and x of one dtype, f32 statistics and "
                        f"a float32 or bfloat16 output, got {g2d.dtype}, "
                        f"{x2d.dtype}, {mean.dtype}, {rstd.dtype}, {dtype}")
    vec = 16 // x2d.element_size()
    if g2d.shape != (m, c) or mean.numel() != m or rstd.numel() != m or \
            m == 0 or c % vec or c > MAX_CHANNELS:
        raise ValueError(f"layer_norm_affine_grads shapes: g "
                         f"{tuple(g2d.shape)} x {tuple(x2d.shape)} mean "
                         f"{tuple(mean.shape)}; C a multiple of {vec} up to "
                         f"{MAX_CHANNELS}")
    for name, t in (("g", g2d), ("x", x2d), ("mean", mean), ("rstd", rstd)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"layer_norm_affine_grads: {name} must be "
                             f"contiguous and 16-byte aligned")
    dev = x2d.get_device()
    rows = affine_rows_per_warp(m, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    blocks = -(-m // (8 * rows))
    if blocks >= 2 ** 31:
        raise ValueError(f"layer_norm_affine_grads: {m} rows exceed the "
                         f"launch grid")
    partial = torch.empty((2, blocks, c), dtype=torch.float32,
                          device=x2d.device)
    out = torch.empty((2, c), dtype=dtype, device=x2d.device)
    err = cuda_build.library().vst_layer_norm_affine_grad(_AFFINE_CALL.pack(
        x2d.data_ptr(), g2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        partial.data_ptr(), out.data_ptr(), cuda_build.stream_of(x2d), m, c,
        dev, _DTYPES[x2d.dtype], _DTYPES[dtype], rows, blocks))
    cuda_build.check_launch("layer_norm_affine_grads", err)
    global AFFINE_LAUNCHES
    AFFINE_LAUNCHES += 1
    return out


def layer_norm_bwd(grad, x, scale, bias, mean, rstd,
                   need=(True, True, True)):
    """The card's LayerNorm backward on the forward's saved f32 mean and
    rstd (M, 1), for the gradients `need` picks of (dx, dscale, dbias);
    the others are None. dx: aten's ``native_layer_norm_backward`` asked
    for dx alone (its kernels take x and the affine in one dtype: a bf16
    x beside an f32 affine is widened, exactly, with its gradient, and dx
    rounded once to x's dtype); dscale, dbias: `layer_norm_affine_grads`,
    rounded once to the affine's dtype (scale and bias share one, as the
    forward prepared them)."""
    c = x.shape[-1]
    x2d = x.reshape(-1, c)
    g2d = grad.reshape(-1, c).contiguous()
    dx = ds = db = None
    if need[0]:
        xa, ga = ((x2d.float(), g2d.float()) if scale.dtype != x.dtype
                  else (x2d, g2d))
        dx = torch.ops.aten.native_layer_norm_backward(
            ga, xa, [c], mean, rstd, scale, bias, [True, False, False])[0]
        dx = dx.to(x.dtype).reshape(x.shape)
    if need[1] or need[2]:
        sums = layer_norm_affine_grads(g2d, x2d, mean, rstd, scale.dtype)
        ds = sums[0] if need[1] else None
        db = sums[1] if need[2] else None
    return dx, ds, db


class _LayerNorm(torch.autograd.Function):
    """K7 on the card with its statistics saved; the backward is
    `layer_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, scale, bias, entry):
        y, mean, rstd = _launch(x, scale, bias, entry, stats=True)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return (*layer_norm_bwd(grad, *ctx.saved_tensors,
                                need=ctx.needs_input_grad[:3]), None)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """LayerNorm over the minor axis with scale and bias, one pass over
    x; differentiable. x: (..., C). On the card with no gradient to
    record, the launch alone."""
    with tracing.op_span("K7", _route_name, x):
        if not x.is_cuda:
            return layer_norm_reference(x, scale, bias, eps)
        entry = _check(x, scale, bias, eps)
        grad = torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or bias.requires_grad)
        if entry[2] or entry[3] is not None:
            x, scale, bias = _prepared(x, scale, bias, entry)
        if grad:
            return _LayerNorm.apply(x, scale, bias, entry)
        return _launch(x, scale, bias, entry)[0]


def _route_name(x) -> str:
    """The kernel a call on x launches, for its span: K7 has one."""
    return "cuda" if x.is_cuda else "plain"
