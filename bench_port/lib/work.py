"""The least time the chip could take for the work asked of an op entry,
counted from the call's shapes and dtypes alone, and the peaks it is
counted against.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16, 3.35
TB/s HBM. Float32 work is counted at the 3xTF32 rate, 494.7 / 3 TFLOP/s:
an implementation that keeps float32 accuracy on the tensor cores needs
three TF32 products a product, so none can read above 100 % (at the
67 TFLOP/s of the FP32 units a tf32x3 kernel would). A flop is a multiply
or an add; each input byte is read once and each output byte written
once. Attention's forward is 4 B H Sq Sk D (two products), the count
of PERF.md's bound column.
"""
from __future__ import annotations

import math

import torch

PEAK_BF16 = 989e12
PEAK_FP32 = 494.7e12 / 3
PEAK_BYTES = 3.35e12


def flop_rate(dtype) -> float:
    return PEAK_FP32 if dtype == torch.float32 else PEAK_BF16


def least_s(flops: float, nbytes: float, dtype) -> float:
    return max(flops / flop_rate(dtype), nbytes / PEAK_BYTES)


def _size(t) -> int:
    return t.numel() * t.element_size()


def flash_attention(q, k, v, **_):
    """q (B, Sq, H, D), k and v (B, Sk, H, D) -> out (B, Sq, H*D)."""
    b, sq, h, d = q.shape
    flops = 4 * b * h * sq * k.shape[1] * d
    nbytes = _size(q) + _size(k) + _size(v) + _size(q)
    return least_s(flops, nbytes, q.dtype)


def flash_attention_qkv(qkv, num_heads, **_):
    """qkv (B, S, 3 H D) read in place -> out (B, S, H D)."""
    b, s, hd3 = qkv.shape
    flops = 4 * b * s * s * (hd3 // 3)
    nbytes = _size(qkv) + _size(qkv) // 3
    return least_s(flops, nbytes, qkv.dtype)


def geglu_projection(x, w, b, **_):
    """x (..., K), w (2N, K), b (2N,) -> h * gelu(g), (..., N)."""
    m = math.prod(x.shape[:-1])
    n2, kdim = w.shape
    flops = 2 * m * kdim * n2
    nbytes = (_size(x) + _size(w) + _size(b)
              + m * (n2 // 2) * x.element_size())
    return least_s(flops, nbytes, x.dtype)


def temporal_attention(q, k, v, **_):
    """q, k, v (F, N, H, d) -> out (F, N, H d): attention over F."""
    f, n, h, d = q.shape
    flops = 4 * n * h * f * f * d
    nbytes = 4 * _size(q)
    return least_s(flops, nbytes, q.dtype)


def layer_norm(x, scale, bias, **_):
    """Bytes bound: x read, the output written, the affine read."""
    nbytes = 2 * _size(x) + _size(scale) + _size(bias)
    return least_s(8 * x.numel(), nbytes, x.dtype)


ENTRIES = {
    "K1": {"flash_attention": flash_attention,
           "flash_attention_qkv": flash_attention_qkv},
    "K2": {"geglu_projection": geglu_projection},
    "K3": {"temporal_attention": temporal_attention},
    "K7": {"layer_norm": layer_norm},
}
