"""K2: fused GEGLU projection — CUDA kernel (csrc/geglu.cu) and its plain
PyTorch version.

Replaces the JAX package's ops/geglu.py Pallas kernel (`_make_kernel`).
``h * gelu(g)`` with ``[h | g] = x @ W^T + b``: the kernel computes the h
and gate tiles of each output tile from the same x tile, reads W's rows
``j`` and ``j + inner`` in place and writes only the (M, inner) result.
On the H100 it is bound by tensor-core throughput in both dtypes. It has
two routes, named by `route`: bf16 ("wgmma") runs on a persistent,
warp-specialised wgmma + TMA kernel in clusters of two blocks that share
W's tiles by multicast, whose gate epilogue overlaps the other
warpgroup's products; fp32 ("tf32x3") runs the same products on the
TF32 tensor cores at 3xTF32 (each operand split into two TF32 halves,
three products a product), W split into its halves by a small kernel
into a scratch buffer each call (see the source).

The gate approximations are the JAX package's, ported op for op, and the
default is dtype-gated exactly as there: ``cdf3`` for bf16/f16 (its
2.6e-5 error is far under bf16 round-off) and ``erf5`` for f32 (cdf3
would break 2e-5 f32 parity).

Every call goes through one ``torch.autograd.Function`` whose backward
is the JAX package's manual `_geglu_bwd` in plain torch ops (XLA there,
not Pallas): it recomputes the two halves instead of saving them and
uses the exact-erf gelu derivative whatever the forward gate. A CUDA
tensor launches the forward kernel or raises; a CPU tensor takes the
plain forward.
"""
from __future__ import annotations

import math
import struct

import torch
import torch.nn.functional as F

from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.utils import tracing

# launches of the CUDA kernel in this process (the plain version and
# refused calls do not count), split by route in ROUTE_LAUNCHES
LAUNCHES = 0
ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0}
_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}

_LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# one K2 call's arguments, packed for its C entry point (csrc/geglu.cu:
# GegluCall) in three parts: the x, w, b and out pointers, the fp32
# route's scratch for W's TF32 halves (0 in bf16) and the stream; the
# layout (the device, dtype, M, C and inner), packed once a layout; the
# gate
_POINTERS = struct.Struct("<6Q")
_LAYOUT = struct.Struct("<5i")
_GATE = {name: struct.pack("<i", i)
         for i, name in enumerate(("erf5", "cdf3", "poly14"))}


def _erf_as(x):
    """Abramowitz-Stegun 7.1.26 rational erf (max abs error 1.5e-7)."""
    sign = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    e = torch.exp2(-(ax * ax) * _LOG2E)
    return sign * (1.0 - poly * e)


def _gelu_exact(x):
    return 0.5 * x * (1.0 + _erf_as(x * (2.0 ** -0.5)))


def _gelu_cdf3(x):
    """gelu via the direct normal CDF (Abramowitz-Stegun 26.2.16, 3
    terms; |err(gelu)| < ~6e-5)."""
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.33267 * ax)
    poly = t * (0.4361836 + t * (-0.1201676 + t * 0.9372980))
    pdf = 0.3989422804014327 * torch.exp2(-(0.5 * _LOG2E) * (ax * ax))
    phi_pos = 1.0 - pdf * poly
    phi = torch.where(x >= 0, phi_pos, 1.0 - phi_pos)
    return x * phi


# degree-14 Chebyshev fit of erf(x/sqrt(2)) = x*R(x^2) in
# t = 2*x^2/XMAX^2 - 1, Horner in the t power basis, input clamped
_P14_XMAX = 5.4
_P14_TSCALE = 2.0 / (_P14_XMAX * _P14_XMAX)
_P14_COEF = (
    0.26185622220921656, -0.13065609481680923, 0.09699951875067843,
    -0.07841408412755317, 0.06422728013461654, -0.051488954314033455,
    0.03932888845773156, -0.027941163343751726, 0.019183359175576342,
    -0.01340499669652595, 0.007504966895981539, -0.0023944706774313563,
    0.0016048457692697362, -0.002049756592036783, 0.00082965585022015,
)


def _gelu_poly14(x):
    xc = torch.clamp(x, -_P14_XMAX, _P14_XMAX)
    t = xc * xc * _P14_TSCALE - 1.0
    r = torch.full_like(t, _P14_COEF[-1])
    for a in _P14_COEF[-2::-1]:
        r = r * t + a
    return 0.5 * x * (1.0 + xc * r)


_GATES = {"erf5": _gelu_exact, "cdf3": _gelu_cdf3, "poly14": _gelu_poly14}


def route(dtype) -> str:
    """The K2 kernel a CUDA call of this dtype launches: "wgmma" (bf16:
    wgmma + TMA, clusters of two sharing W by multicast) or "tf32x3"
    (fp32: TF32 wgmma at three products a product), both in
    csrc/geglu.cu. Raises on what K2 does not take."""
    if dtype not in _ROUTES:
        raise TypeError(f"geglu takes float32 or bfloat16, got {dtype}")
    return _ROUTES[dtype]


def _default_gate_for(dtype) -> str:
    if dtype in (torch.float32, torch.float64):
        return "erf5"
    return "cdf3"


def geglu_plain(x2d, w, b, gate: str):
    """x2d (M, C), w (2*inner, C), b (2*inner,): ``x @ w^T + b`` in x's
    dtype, then the gate in f32 (the JAX package's `_reference`)."""
    y = F.linear(x2d, w.to(x2d.dtype), b.to(x2d.dtype))
    h, g = y.chunk(2, dim=-1)
    return h * _GATES[gate](g.float()).to(h.dtype)


# layouts `_check` has accepted, by the dtypes, devices, shapes, strides
# and pointer alignment of x, w and b: the packed layout part of the call
_ACCEPTED = {}


def _check(x2d, w, b):
    """Raises on (x, w, b) that K2 does not take; returns the packed layout
    part of its call. A layout accepted once is found again after one dict
    lookup."""
    key = (x2d.dtype, w.dtype, b.dtype,
           x2d.get_device(), w.get_device(), b.get_device(),
           x2d.shape, w.shape, b.shape, x2d.stride(), w.stride(), b.stride(),
           (x2d.data_ptr() | w.data_ptr() | b.data_ptr()) % 16)
    entry = _ACCEPTED.get(key)
    if entry is None:
        _check_layout(x2d, w, b)
        m, c = x2d.shape
        entry = _LAYOUT.pack(x2d.get_device(), _DTYPES[x2d.dtype], m, c,
                             w.shape[0] // 2)
        if len(_ACCEPTED) >= 4096:
            _ACCEPTED.clear()
        _ACCEPTED[key] = entry
    return entry


def _check_layout(x2d, w, b):
    """Raises on (x, w, b) that K2 does not take."""
    if not (x2d.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError("geglu: x, w, b must all be on CUDA")
    if not (x2d.device == w.device == b.device):
        raise ValueError("geglu: x, w, b on different devices")
    if x2d.dtype not in _DTYPES or not (x2d.dtype == w.dtype == b.dtype):
        raise TypeError(f"geglu takes float32 or bfloat16 x/w/b of one "
                        f"dtype, got {x2d.dtype}, {w.dtype}, {b.dtype}")
    m, c = x2d.shape
    if w.dim() != 2 or w.shape[1] != c or w.shape[0] % 2 or b.shape != (
            w.shape[0],):
        raise ValueError(f"geglu shapes: x {tuple(x2d.shape)} w "
                         f"{tuple(w.shape)} b {tuple(b.shape)}")
    inner = w.shape[0] // 2
    if c % 8 or inner % 8 or min(c, inner) < 8:
        raise ValueError(f"geglu needs C and inner positive multiples of 8, "
                         f"got {c}, {inner}")
    for name, t in (("x", x2d), ("w", w), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"geglu: {name} must be contiguous and "
                             f"16-byte aligned")
    # both kernels are persistent: one block an SM walks the tiles
    if not 1 <= m < 2 ** 31:
        raise ValueError(f"geglu: {m} rows, not within the launch grid")


def geglu_fwd(x2d, w, b, gate: str):
    """x2d (M, C) -> (M, inner) (K2; no autograd)."""
    if not x2d.is_cuda:
        return geglu_plain(x2d, w, b, gate)
    layout = _check(x2d, w, b)
    out = x2d.new_empty((x2d.shape[0], w.shape[0] // 2))
    kernel = _ROUTES[x2d.dtype]
    # the fp32 route's W.hi and W.lo (2 x (2 inner, C) floats)
    split = w.new_empty((2, *w.shape)) if kernel == "tf32x3" else None
    err = cuda_build.library().vst_geglu_fwd(
        _POINTERS.pack(x2d.data_ptr(), w.data_ptr(), b.data_ptr(),
                       out.data_ptr(), 0 if split is None
                       else split.data_ptr(), cuda_build.stream_of(x2d))
        + layout + _GATE[gate])
    cuda_build.check_launch("geglu_projection", err)
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[kernel] += 1
    return out


def geglu_bwd(x2d, w, b, g_out, need=(True, True, True)):
    """The JAX `_geglu_bwd`: recompute yh = x Wh^T + bh and yg = x Wg^T +
    bg in x's dtype, then with phi/pdf of the exact normal CDF in f32
    (d/dz[z*Phi(z)] = Phi(z) + z*pdf(z)) form dyh = g*gelu(yg) and dyg =
    g*yh*gelu'(yg) in x's dtype; dx = dyh Wh + dyg Wg, dW = [dyh^T x;
    dyg^T x], db = [sum dyh; sum dyg]. `need` picks which of (dx, dW,
    db) to compute (frozen weights need dx only); the others are None."""
    dt = x2d.dtype
    inner = w.shape[0] // 2
    wh, wg = w[:inner].to(dt), w[inner:].to(dt)
    yh = F.linear(x2d, wh, b[:inner].to(dt))
    yg = F.linear(x2d, wg, b[inner:].to(dt)).float()
    phi = 0.5 * (1.0 + torch.erf(yg * (2.0 ** -0.5)))
    pdf = (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * yg * yg)
    gf = g_out.float()
    dyh = (gf * (yg * phi)).to(dt)
    dyg = (gf * yh.float() * (phi + yg * pdf)).to(dt)
    del yh, yg, phi, pdf, gf
    dx = dw = db = None
    if need[0]:
        dx = torch.addmm(dyh @ wh, dyg, wg)
    if need[1]:
        dw = torch.cat([dyh.t() @ x2d, dyg.t() @ x2d]).to(w.dtype)
    if need[2]:
        db = torch.cat([dyh.sum(0), dyg.sum(0)]).to(b.dtype)
    return dx, dw, db


class _Geglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, gate):
        ctx.save_for_backward(x2d, w, b)
        return geglu_fwd(x2d, w, b, gate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x2d, w, b = ctx.saved_tensors
        dx, dw, db = geglu_bwd(x2d, w, b, grad, ctx.needs_input_grad[:3])
        return dx, dw, db, None


def geglu_projection(x, w, b, *, gate: str = None):
    """x: (..., C); w: (2*inner, C); b: (2*inner,). Returns (..., inner)
    = h * gelu(g) with [h | g] = x @ w^T + b; differentiable."""
    with tracing.op_span("K2", _route_name, x):
        if gate is None:
            gate = _default_gate_for(x.dtype)
        c = x.shape[-1]
        inner = w.shape[0] // 2
        lead = x.shape[:-1]
        x2d = x.reshape(-1, c)
        return _Geglu.apply(x2d, w, b, gate).reshape(*lead, inner)


def _route_name(x) -> str:
    """The route a call on x launches, for its span."""
    return _ROUTES.get(x.dtype, "?") if x.is_cuda else "plain"
