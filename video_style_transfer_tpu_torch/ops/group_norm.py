"""GroupNorm, alone or followed by SiLU, over channels-last activations:
CUDA kernels (csrc/group_norm.cu) and the plain PyTorch version.

Every GroupNorm of the port's models comes here
(``models/layers.py:group_norm``): the UNet's resnets, transformers and
motion modules, its ``conv_norm_out``, the VAE's decoder and encoder.
The JAX package's GroupNorm is XLA, which fuses it into its neighbours;
in eager PyTorch its formula is about eleven launches a call, with an
f32 copy of the activation, and a SiLU pass of its own. This replaces no
TPU kernel.

x (B, ..., C): each row b and group of C / num_groups channels is
normalised over all its positions, with f32 statistics and an f32
affine, rounded once to x's dtype; with ``silu`` the rounded output is
put through SiLU and rounded again, which is ``F.silu`` of the unfused
output.

A CPU tensor takes the plain version (the formula the models used before
this module, unchanged) and its autograd. A CUDA tensor launches the
kernels or raises:
- with no gradient to record (serving runs under
  ``torch.inference_mode``), the bare launcher runs: one layout check,
  cached by layout, the output's allocation and one C call (two
  launches: the statistics, then the normalisation) with its arguments
  packed in one struct;
- with one (the trainers), an autograd Function's forward launches the
  same kernels and saves x; its backward is the vjp of the plain formula
  recomputed from x, so the gradients are the plain autograd's.
The affine goes to the kernels as it is held where that is f32 or bf16
(both in one dtype); otherwise it is cast to f32.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch
import torch.nn.functional as F

from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.utils import tracing

# calls that launched the kernels in this process (the plain version and
# refused calls do not count), and of those the calls with SiLU fused
LAUNCHES = 0
SILU_LAUNCHES = 0
# copies of x made because x was not contiguous or not 16-byte aligned
COPIES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUPS = 1024
# a statistics block holds threads * (16 / itemsize) floats of each of
# mean and M2 in shared memory (csrc/group_norm.cu: kStatFloats)
STAT_FLOATS = 4096
# one call's arguments, packed for its C entry point (csrc/group_norm.cu:
# GroupNormCall) in two parts: the x, weight, bias, y and partial-sum
# pointers and the stream; the layout (rows, positions, positions a
# chunk, C, groups, chunks, threads, the device, x's and the affine's
# dtypes, silu, eps), packed once a layout
_POINTERS = struct.Struct("<6Q")
_LAYOUT = struct.Struct("<3q8if4x")


def group_norm_plain(x, weight, bias, num_groups: int, eps: float = 1e-5):
    """GroupNorm over channels-last x (B, ..., C): each group of
    C/num_groups channels is normalised jointly with all positions, with
    f32 statistics (torch.nn.GroupNorm semantics)."""
    c = x.shape[-1]
    lead = x.shape[0]
    xf = x.reshape(lead, -1, num_groups, c // num_groups).float()
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    # fold the statistics and the affine into per-(row, channel) f32
    # scale and shift (the JAX package's form), then one pass computes
    # x*scale + shift in f32 and rounds once into the input dtype
    scale = torch.rsqrt(var + eps) * weight.float().view(num_groups, -1)
    shift = bias.float().view(num_groups, -1) - mean * scale
    if scale.requires_grad or shift.requires_grad:
        # autograd cannot differentiate an ``out=`` write: the same f32
        # affine as a graph op, rounded once to the input dtype
        return torch.addcmul(shift, xf, scale).to(x.dtype).reshape(x.shape)
    out = torch.empty(xf.shape, dtype=x.dtype, device=x.device)
    torch.addcmul(shift, xf, scale, out=out)
    return out.reshape(x.shape)


def group_norm_reference(x, weight, bias, num_groups: int, eps: float = 1e-5,
                         silu: bool = False):
    """`group_norm_plain`, then ``F.silu`` where `silu`: what the kernels
    compute, in the plain version's order of sums."""
    y = group_norm_plain(x, weight, bias, num_groups, eps)
    return F.silu(y) if silu else y


def block_threads(channels: int, itemsize: int):
    """(threads, k) of a block for rows of `channels` values of
    `itemsize` bytes: each thread takes one 16-byte vector of a position,
    k positions a step, threads = k * channels / (16 / itemsize) a
    multiple of 32 and at most STAT_FLOATS / (16 / itemsize) (512 in
    bf16, 1024 in f32), as many as that allows. Raises where no k fits."""
    vec = 16 // itemsize
    nv = channels // vec
    step = 32 // math.gcd(nv, 32)  # k's multiple for whole warps
    k = (STAT_FLOATS // vec // nv) // step * step if nv else 0
    if k == 0:
        raise ValueError(f"group_norm kernel takes C up to "
                         f"{STAT_FLOATS // vec * vec} whose 16-byte vectors "
                         f"fill whole warps, got C = {channels}")
    return k * nv, k


def launch_plan(rows: int, positions: int, k: int, wave: int):
    """(chunks, chunk): each row's positions cut into `chunks` runs of
    `chunk` (the last may hold fewer, none is empty), so that rows *
    chunks blocks fill one `wave` of resident blocks where the rows allow
    it, and a block of k positions a step takes at least k positions."""
    chunks = max(1, min(wave // rows, -(-positions // k)))
    chunk = -(-positions // chunks)
    return -(-positions // chunk), chunk


def chunk_bounds(positions: int, chunks: int, chunk: int):
    """[start, end) of each chunk of a row, as the kernels take them."""
    return [(i * chunk, min((i + 1) * chunk, positions))
            for i in range(chunks)]


# layouts the kernels have accepted, by the dtypes, devices, shapes,
# contiguity and pointer alignment of x, weight and bias, the groups, eps
# and silu: (the packed layout part of the call, x's device, whether x
# needs a contiguous copy, the dtype the affine is cast or copied to or
# None, the partial sums' floats, silu)
_ACCEPTED = {}
# each (device, stream)'s partial-sum scratch, grown to the largest call
_SCRATCH = {}
# blocks of both kernels an SM holds, by (device, dtype, affine dtype,
# silu, threads)
_RESIDENT = {}
_fwd = None  # the bound C entry point, once the library is loaded


def _key(x, weight, bias, num_groups, eps, silu):
    return (x.dtype, weight.dtype, bias.dtype, x.get_device(),
            weight.get_device(), bias.get_device(), x.shape, weight.shape,
            bias.shape, x.is_contiguous(), weight.is_contiguous(),
            bias.is_contiguous(), x.data_ptr() & 15, num_groups, eps, silu)


def _check(x, weight, bias, num_groups, eps, silu):
    """Raises on what the kernels do not take; returns the call's entry
    in `_ACCEPTED`, found again after one dict lookup."""
    key = _key(x, weight, bias, num_groups, eps, silu)
    entry = _ACCEPTED.get(key)
    if entry is None:
        entry = _layout(x, weight, bias, num_groups, eps, silu)
        if len(_ACCEPTED) >= 4096:
            _ACCEPTED.clear()
        _ACCEPTED[key] = entry
    return entry


def _layout(x, weight, bias, num_groups, eps, silu):
    """Raises on (x, weight, bias, num_groups) that the kernels do not
    take, shapes and dtypes first, then devices; else the call's entry
    in `_ACCEPTED`."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if not (weight.is_floating_point() and bias.is_floating_point()):
        raise TypeError(f"group_norm takes a floating weight and bias, got "
                        f"{weight.dtype} and {bias.dtype}")
    c = x.shape[-1] if x.dim() >= 2 else 0
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm shapes: x {tuple(x.shape)} weight "
                         f"{tuple(weight.shape)} bias {tuple(bias.shape)}")
    vec = 16 // x.element_size()
    if not (0 < num_groups <= MAX_GROUPS) or c % num_groups or c % vec:
        raise ValueError(f"group_norm kernel takes C a multiple of "
                         f"num_groups (at most {MAX_GROUPS}) and of {vec} "
                         f"for {x.dtype}, got C = {c}, num_groups = "
                         f"{num_groups}")
    rows = x.shape[0]
    positions = x.numel() // (rows * c) if rows else 0
    if positions == 0:
        raise ValueError(f"group_norm kernel takes a non-empty x, got "
                         f"{tuple(x.shape)}")
    threads, k = block_threads(c, x.element_size())
    if not (x.is_cuda and weight.is_cuda and bias.is_cuda
            and x.device == weight.device == bias.device):
        raise ValueError("group_norm: x, weight, bias must be on one CUDA "
                         "device")
    keep = weight.dtype == bias.dtype and weight.dtype in _DTYPES
    affine = weight.dtype if keep else torch.float32
    prepare = not (keep and weight.is_contiguous() and bias.is_contiguous())
    copy = not x.is_contiguous() or x.data_ptr() % 16 != 0
    dev = x.get_device()
    wave = torch.cuda.get_device_properties(dev).multi_processor_count * \
        _resident(dev, x.dtype, affine, silu, threads)
    chunks, chunk = launch_plan(rows, positions, k, wave)
    if rows * chunks >= 2 ** 31:
        raise ValueError(f"group_norm: {rows} rows exceed the launch grid")
    return (_LAYOUT.pack(rows, positions, chunk, c, num_groups, chunks,
                         threads, dev, _DTYPES[x.dtype], _DTYPES[affine],
                         int(silu), eps),
            dev, copy, affine if prepare else None,
            2 * rows * num_groups * chunks, silu)


def _bind():
    global _fwd
    _fwd = cuda_build.library().vst_group_norm_fwd
    return _fwd


def _resident(dev, dtype, affine, silu, threads):
    """Blocks of `threads` of both kernels one SM of `dev` holds at once
    (the occupancy the registers and shared memory allow)."""
    key = (dev, dtype, affine, silu, threads)
    n = _RESIDENT.get(key)
    if n is None:
        out = ctypes.c_int(0)
        err = cuda_build.library().vst_group_norm_resident(
            _DTYPES[dtype], _DTYPES[affine], int(silu), threads, dev,
            ctypes.byref(out))
        cuda_build.check_launch("group_norm occupancy", err)
        if out.value < 1:
            raise RuntimeError(f"group_norm: no block of {threads} threads "
                               f"fits an SM")
        n = _RESIDENT[key] = out.value
    return n


def _scratch(dev, stream, floats):
    """The (device, stream)'s partial-sum scratch of at least `floats`
    f32: calls on one stream run in order, so each may reuse it."""
    buf = _SCRATCH.get((dev, stream))
    if buf is None or buf.numel() < floats:
        buf = _SCRATCH[(dev, stream)] = torch.empty(
            floats, dtype=torch.float32, device=torch.device("cuda", dev))
    return buf


def _launch(x, weight, bias, entry):
    """The kernels on checked, contiguous, aligned x and a prepared
    affine: y like x."""
    y = torch.empty_like(x)
    stream = cuda_build.stream_of(x)
    partial = _scratch(entry[1], stream, entry[4])
    err = (_fwd or _bind())(
        _POINTERS.pack(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                       y.data_ptr(), partial.data_ptr(), stream) + entry[0])
    cuda_build.check_launch("group_norm", err)
    global LAUNCHES, SILU_LAUNCHES
    LAUNCHES += 1
    SILU_LAUNCHES += entry[5]
    return y


def _prepared(x, weight, bias, entry):
    """(x, weight, bias) ready for `_launch`: a contiguous, aligned copy
    of x where it is not one; the affine cast to f32 where its two
    tensors are not both f32 or both bf16, or copied where not
    contiguous."""
    _, _, copy, affine = entry[:4]
    if copy:
        x = x.clone(memory_format=torch.contiguous_format)
        global COPIES
        COPIES += 1
    if affine is not None:
        weight = weight.to(affine, copy=True)
        bias = bias.to(affine, copy=True)
    return x, weight, bias


class _GroupNorm(torch.autograd.Function):
    """The kernels on the card with x saved; the backward is the vjp of
    the plain formula recomputed from x."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, entry):
        ctx.save_for_backward(x, weight, bias)
        ctx.args = (num_groups, eps, entry[5])
        return _launch(x, weight, bias, entry)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = group_norm_reference(*leaves, *ctx.args)
        grads = iter(torch.autograd.grad(
            y, [t for t, n in zip(leaves, need) if n], grad))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def group_norm(x, weight, bias, num_groups: int, *, eps: float = 1e-5,
               silu: bool = False):
    """GroupNorm of channels-last x (B, ..., C) with weight and bias (C,),
    followed by SiLU where `silu`; differentiable. On the card with no
    gradient to record, the launch alone."""
    with tracing.op_span("GN", _route_name, x):
        if not x.is_cuda:
            return group_norm_reference(x, weight, bias, num_groups, eps,
                                        silu)
        entry = _check(x, weight, bias, num_groups, eps, silu)
        if entry[2] or entry[3] is not None:
            x, weight, bias = _prepared(x, weight, bias, entry)
        if torch.is_grad_enabled() and (
                x.requires_grad or weight.requires_grad
                or bias.requires_grad):
            return _GroupNorm.apply(x, weight, bias, num_groups, eps, entry)
        return _launch(x, weight, bias, entry)


def _route_name(x) -> str:
    """The path a call on x takes, for its span."""
    return "cuda" if x.is_cuda else "plain"
