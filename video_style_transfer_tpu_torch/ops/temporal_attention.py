"""K3: per-pixel temporal (frame-axis) attention forward
(csrc/temporal_attention.cu) and K5: its backward
(csrc/temporal_attention_bwd.cu), each beside its plain PyTorch version.

K3 replaces the JAX package's ops/temporal_attention.py Pallas kernel
`_kernel`, K5 its `_bwd_kernel`. The motion module keeps tokens as (F, N, C), so q/k/v come
out of one (C, 3P) projection as (F, N, 3P) and reach the kernel as
(F, N, H, d) strided views; the output is (F, N, P). The JAX package's
per-frame (P, N) lists are a TPU lane-layout choice with no counterpart
here. On the H100 both kernels are bound by device-memory bandwidth; each
runs a (pixel, head) pair's products on the tensor cores (mma.sync; fp32
at 3xTF32), fed and drained by TMA (see the sources for their designs).
Both take every clip that `pair_fits`; K5's stages are planned here
(`bwd_plan`) and passed in its call.

Every call goes through one ``torch.autograd.Function`` (residuals q, k,
v, as in JAX). A CUDA tensor launches the kernels or raises; a CPU
tensor takes the plain versions.
"""
from __future__ import annotations

import math
import struct

import torch

from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.utils import tracing

# kernel launches in this process: LAUNCHES the forward (K3),
# BWD_LAUNCHES the backward (K5)
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one K3 call's arguments, packed for its C entry point
# (csrc/temporal_attention.cu: TACall) in three parts: the q, k, v and out
# pointers and the stream; the layout (q's, k's and v's (frame, pixel,
# head) strides, the device, dtype, F, N, H and d), packed once a layout;
# the scale
_POINTERS = struct.Struct("<5Q")
_LAYOUT = struct.Struct("<9q6i")
_SCALE = struct.Struct("<f4x")
# one K5 call's arguments (csrc/temporal_attention_bwd.cu: TABwdCall): the
# q, k, v, dO, dq, dk and dv pointers and the stream, K3's layout part,
# the plan (`bwd_plan`), the scale
_BWD_POINTERS = struct.Struct("<8Q")
_BWD_PLAN = struct.Struct("<6i")
MAX_FRAMES = 32
# shared memory one block may take on Hopper (227 KB of the SM's 256)
MAX_BLOCK_SMEM = 232448
# elements one dimension of a TMA box may span
MAX_BOX = 256
# K5's ring: bytes a stage of q, k, v and dO aims at, and its stages
BWD_STAGE_TARGET = 36 * 1024
BWD_MAX_STAGES = 8


def pair_fits(frames: int, head_dim: int, itemsize: int) -> bool:
    """Whether K3 and K5 take clips of `frames` frames at `head_dim`: one
    (pixel, head) pair's F x d q, k and v tiles (`itemsize` bytes each)
    share one block's shared memory. csrc/temporal_attention.cu takes
    every such pair: its shared memory holds the stages (at least one
    pair) and 32 bytes of barriers and zero row, which the pairs' sizes (a
    multiple of 48 bytes) always leave free. K5 needs four tiles of a pair
    at once, so where they do not fit it takes the pair in column chunks
    (`bwd_plan`): the one rule holds for both."""
    return 3 * frames * head_dim * itemsize <= MAX_BLOCK_SMEM


def bwd_plan(frames: int, head_dim: int, itemsize: int, heads: int,
             n: int):
    """K5's stages for (F, N, H, d) clips of `itemsize`-byte elements:
    (ldp, cols, chunks, hb, tn, stages).

    Where a pair's row fits one TMA box, a stage holds whole pairs: hb
    heads (the most that divide H and fit BWD_STAGE_TARGET) x tn pixels of
    q, k, v and dO, rows ldp apart, ldp = d or d plus one 16-byte chunk (an
    odd count of chunks keeps ldmatrix free of bank conflicts, as K3);
    cols = d, chunks = 1. Otherwise a stage holds one column chunk of one
    pair, cols = ldp columns (bf16: an odd count of chunks), `chunks` of
    them to a row. `stages` fill the block's shared memory (at most
    BWD_MAX_STAGES), beside 16 bytes of barriers a stage and a zero row."""
    f, d, es = frames, head_dim, itemsize
    vec = 16 // es
    ldp = d + vec if (d // vec) % 2 == 0 else d
    if ldp <= MAX_BOX:
        pair = 4 * f * ldp * es
        hb = next((x for x in range(min(heads, MAX_BOX), 0, -1)
                   if heads % x == 0 and x * pair <= BWD_STAGE_TARGET), 1)
        tn = max(1, min(BWD_STAGE_TARGET // (hb * pair), MAX_BOX, n))
        cols, chunks = d, 1
    else:
        cols = BWD_STAGE_TARGET // (4 * f * es) // 8 * 8
        cols = min(MAX_BOX, max(8, cols))
        if es == 2 and cols // 8 % 2 == 0:
            cols -= 8
        ldp, chunks, hb, tn = cols, -(-d // cols), 1, 1
    stage = 4 * (-(-hb * tn * f * ldp * es // 128) * 128)
    stages = min(BWD_MAX_STAGES, (MAX_BLOCK_SMEM - 16) // (stage + 16))
    return ldp, cols, chunks, hb, tn, stages


def temporal_attention_plain(q, k, v, scale: float):
    """q, k, v: (F, N, H, d) -> (F, N, H*d): softmax over the frame axis
    per pixel and head (the einsum form of the JAX `_reference_stacked`:
    f32 logits and accumulation, weights rounded to v's dtype)."""
    f, n, h, d = q.shape
    logits = torch.einsum("fnhd,gnhd->nhfg", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("nhfg,gnhd->fnhd", w.to(v.dtype).float(), v.float())
    return o.to(q.dtype).reshape(f, n, h * d)


def temporal_attention_bwd_plain(q, k, v, do, scale: float):
    """The JAX `_bwd_kernel` math in f32: recompute w = softmax over
    frames, dp_fg = do_f . v_g, delta_f = sum_g w_fg dp_fg, ds_fg =
    w_fg (dp_fg - delta_f) scale; dq_f = sum_g ds_fg k_g, dk_g = sum_f
    ds_fg q_f, dv_g = sum_f w_fg do_f. q, k, v: (F, N, H, d); do:
    (F, N, H*d). Returns dq, dk, dv, each (F, N, H, d) in q's dtype."""
    f, n, h, d = q.shape
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.reshape(f, n, h, d).float()
    w = torch.softmax(torch.einsum("fnhd,gnhd->nhfg", qf, kf) * scale, -1)
    dp = torch.einsum("fnhd,gnhd->nhfg", dof, vf)
    delta = (w * dp).sum(-1, keepdim=True)
    ds = w * (dp - delta) * scale
    dq = torch.einsum("nhfg,gnhd->fnhd", ds, kf)
    dk = torch.einsum("nhfg,fnhd->gnhd", ds, qf)
    dv = torch.einsum("nhfg,fnhd->gnhd", w, dof)
    return dq.to(dt), dk.to(dt), dv.to(dt)


# layouts `_check` has accepted, by the dtypes, devices, shapes, strides
# and pointer alignment of q, k and v: the packed layout part of K3's and
# K5's calls
_ACCEPTED = {}


def _check(q, k, v):
    """Raises on (F, N, H, d) views that K3 and K5 do not take; returns
    the packed layout part of their calls. A layout accepted once is found
    again after one dict lookup."""
    key = (q.dtype, k.dtype, v.dtype,
           q.get_device(), k.get_device(), v.get_device(),
           q.shape, k.shape, v.shape, q.stride(), k.stride(), v.stride(),
           (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16)
    entry = _ACCEPTED.get(key)
    if entry is None:
        _check_layout(q, k, v)
        entry = _LAYOUT.pack(*q.stride()[:3], *k.stride()[:3],
                             *v.stride()[:3], q.get_device(),
                             _DTYPES[q.dtype], *q.shape)
        if len(_ACCEPTED) >= 4096:
            _ACCEPTED.clear()
        _ACCEPTED[key] = entry
    return entry


def _check_layout(q, k, v):
    """Raises on (F, N, H, d) views that K3 and K5 do not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("temporal attention: q, k, v must all be on CUDA")
    if not (q.device == k.device == v.device):
        raise ValueError("temporal attention: q, k, v on different devices")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"temporal attention takes float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("temporal attention takes equal (F, N, H, d) views")
    f, n, h, d = q.shape
    if not 1 <= f <= MAX_FRAMES:
        raise ValueError(f"temporal attention: {f} frames, at most "
                         f"{MAX_FRAMES}")
    vec = 16 // q.element_size()
    if d % 8:
        raise ValueError(f"temporal attention: head_dim {d} is not a "
                         f"multiple of 8")
    if not pair_fits(f, d, q.element_size()):
        raise ValueError("temporal attention: one (pixel, head) pair "
                         "exceeds a block's shared memory")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"temporal attention: {name} needs unit "
                             f"stride along d")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"temporal attention: {name} strides/pointer "
                             f"not 16-byte aligned")
    if n * h >= 2 ** 31:
        raise ValueError("temporal attention: N*H beyond the launch grid")


def temporal_attention_fwd(q, k, v, *, scale=None):
    """q, k, v: (F, N, H, d) views -> (F, N, H*d) (K3; no autograd)."""
    f, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return temporal_attention_plain(q, k, v, scale)
    layout = _check(q, k, v)
    out = q.new_empty((f, n, h * d))
    err = cuda_build.library().vst_temporal_attention_fwd(
        _POINTERS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), cuda_build.stream_of(q))
        + layout + _SCALE.pack(scale))
    cuda_build.check_launch("temporal_attention", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


# K5's plans by (F, N, H, d, itemsize), packed for its call
_BWD_PLANS = {}


def temporal_attention_bwd(q, k, v, do, *, scale=None):
    """Gradients of `temporal_attention_fwd` (K5): (dq, dk, dv), each
    (F, N, H, d) contiguous in q's dtype."""
    f, n, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return temporal_attention_bwd_plain(q, k, v, do, scale)
    do = do.contiguous()
    # a TMA map takes no zero stride (an expanded view): such a view is
    # copied to a dense one first
    q, k, v = (t.clone(memory_format=torch.contiguous_format)
               if 0 in t.stride()[:3] else t for t in (q, k, v))
    layout = _check(q, k, v)
    if (tuple(do.shape) != (f, n, h * d) or do.dtype != q.dtype
            or do.device != q.device or do.data_ptr() % 16):
        raise ValueError(f"temporal attention backward: do "
                         f"{tuple(do.shape)} {do.dtype}, expected "
                         f"{(f, n, h * d)} {q.dtype} on {q.device}")
    key = (f, n, h, d, q.element_size())
    plan = _BWD_PLANS.get(key)
    if plan is None:
        if len(_BWD_PLANS) >= 4096:
            _BWD_PLANS.clear()
        plan = _BWD_PLANS[key] = _BWD_PLAN.pack(*bwd_plan(
            f, d, q.element_size(), h, n))
    dq, dk, dv = (torch.empty((f, n, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    err = cuda_build.library().vst_temporal_attention_bwd(
        _BWD_POINTERS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), cuda_build.stream_of(q))
        + layout + plan + _SCALE.pack(scale))
    cuda_build.check_launch("temporal_attention_bwd", err)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv


class _TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return temporal_attention_fwd(q, k, v, scale=scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = temporal_attention_bwd(q, k, v, grad, scale=ctx.scale)
        return dq, dk, dv, None


def temporal_attention(q, k, v, *, scale=None):
    """q, k, v: (F, N, H, d) views -> (F, N, H*d), differentiable (K5)."""
    with tracing.op_span("K3", _route_name, q):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        return _TemporalAttention.apply(q, k, v, float(scale))


def _route_name(x) -> str:
    """The kernel a call on x launches, for its span: K3's mma kernel."""
    return "mma" if x.is_cuda else "plain"
