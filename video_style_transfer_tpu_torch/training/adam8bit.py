"""Blockwise 8-bit AdamW (the JAX package's training/adam8bit.py, the
counterpart of bitsandbytes' 8-bit Adam).

The Adam moments of every tensor of at least MIN_8BIT_SIZE elements
are stored as 8-bit codes with one fp32 scale per block of 256:

- m: symmetric linear absmax int8, q = round(m / (absmax / 127));
- sqrt(v): an unsigned log-spaced code. Code 0 is exact zero; codes
  1..255 cover [absmax / 1e5, absmax] geometrically, values below the
  floor clamped up to it, so nothing nonzero decodes to zero.

Smaller tensors keep exact fp32 moments. An update dequantizes, runs
Adam's moment update and bias correction in fp32, requantizes, then adds
the decoupled weight decay and scales by the learning rate, in the order
of the JAX package's ``adamw8bit`` chain, after the global-norm clip.

The arithmetic is plain PyTorch on whatever device the tensors are on,
one correctly rounded operation at a time: divisions by a tensor (a
division by a host scalar may become a multiplication by its reciprocal
on the card), multiplications by host scalars, square roots through
float64 (the CPU's float32 one is not correctly rounded), fused
multiply-adds through float64, the log code found by comparing
against its 254 rounding boundaries and decoded through a 256-entry
table, both made once on the host. So the card and the CPU give the same
codes, scales and updates for the same gradients.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from video_style_transfer_tpu_torch.training.stage2 import AdamW

BLOCK = 256
MIN_8BIT_SIZE = 4096
# sqrt(v)'s range per block: codes 1..255 span [absmax / _V_RANGE, absmax]
_V_RANGE = 1e5
_V_LOGR = float(np.float32(11.512925))  # ln(1e5), as the JAX package's f32
# m's scale is absmax times the float32 reciprocal of 127, as the JAX
# package's compiled update computes absmax / 127
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _v_tables():
    """(boundaries float64, values float32), on the host: code k (1..255)
    holds the r = x / absmax in [1e-5, 1] with round(ln(r) / LOGR * 254 +
    255) == k, so boundary k (1..254) is the least r of code k + 1. Code
    k decodes to exp((k - 255) * (LOGR * (1 / 254))), its exponent in
    float32 as the JAX package's compiled update computes it (the
    compiler folds the two constants); code 0 to 0."""
    k = np.arange(1, 255, dtype=np.float64)
    bounds = np.exp((k + 0.5 - 255.0) / 254.0 * _V_LOGR)
    f32 = np.float32
    arg = (np.arange(256, dtype=f32) - f32(255.0)) * (
        f32(_V_LOGR) * (f32(1.0) / f32(254.0)))
    values = np.exp(arg.astype(np.float64)).astype(f32)
    values[0] = 0.0
    return bounds, values


def _f32_at_least(x):
    """The least float32 >= each float64 of x."""
    f = x.astype(np.float32)
    low = f.astype(np.float64) < x
    f[low] = np.nextafter(f[low], np.float32(np.inf))
    return f


_BOUNDS, _VALUES = _v_tables()
_TABLES = {}


def _tables(device):
    """The sqrt(v) code's boundaries and values as float32 on `device`."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = (
            torch.from_numpy(_f32_at_least(_BOUNDS)).to(device),
            torch.from_numpy(_VALUES).to(device))
    return _TABLES[key]


def _blocked(x):
    """Flatten to (nb, BLOCK) float32, zero-padded."""
    flat = x.reshape(-1).float()
    return F.pad(flat, (0, -flat.numel() % BLOCK)).reshape(-1, BLOCK)


def _unblocked(b, shape):
    return b.reshape(-1)[:int(np.prod(shape, dtype=np.int64))].reshape(shape)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a, c float32 tensors, b a
    float32 tensor or value), as the JAX package's compiled update fuses
    these sums; through float64, where a * b is exact."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    return (a.double() * b + c.double()).float()


def _sqrt(x):
    """The correctly rounded float32 square root: the CPU's vectorised
    float32 sqrt is not (it differs from IEEE in the last bit), the float64
    one is close enough that its rounding to float32 is."""
    return torch.sqrt(x.double()).float()


def _safe(s):
    return torch.where(s > 0, s, torch.ones_like(s))


def quantize(x):
    """Symmetric linear int8 per block: {"q": int8 (nb, BLOCK) in
    [-127, 127], "s": float32 (nb, 1) = absmax / 127}."""
    b = _blocked(x)
    s = b.abs().amax(dim=1, keepdim=True) * _INV127
    return {"q": torch.round(b / _safe(s)).to(torch.int8), "s": s}


def dequantize(state, shape):
    return _unblocked(state["q"].float() * state["s"], shape)


def quantize_sqrtv(x):
    """Unsigned log-spaced 8 bits for x >= 0: {"q": uint8 (nb, BLOCK),
    "s": float32 (nb, 1) = the block's max}."""
    b = _blocked(x)
    s = b.amax(dim=1, keepdim=True)
    r = torch.clamp(b / _safe(s), min=1.0 / _V_RANGE)
    bounds, _ = _tables(b.device)
    q = 1 + torch.bucketize(r, bounds, right=True)
    return {"q": torch.where(b > 0, q, 0).to(torch.uint8), "s": s}


def dequantize_sqrtv(state, shape):
    _, values = _tables(state["q"].device)
    return _unblocked(state["s"] * values[state["q"].long()], shape)


class AdamW8bit(AdamW):
    """AdamW with blockwise 8-bit moments; the interface of
    ``training.stage2.AdamW`` (clip, step, state_dict). A moment entry is
    {"q", "s"} for a quantized tensor, else a float32 tensor."""

    kind = "adamw8bit"

    def __init__(self, params: List[torch.Tensor], schedule: Callable,
                 **kw):
        super().__init__(params, schedule, **kw)
        # the constants as the float32 values the update multiplies by
        self._1mb1, self._wd = (float(np.float32(x)) for x in (
            1.0 - self.b1, self.weight_decay))

    @staticmethod
    def quantized(p) -> bool:
        return p.numel() >= MIN_8BIT_SIZE

    def init_moments(self):
        self.m, self.v = [], []
        for p in self.params:
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if self.quantized(p):
                self.m.append(quantize(z))
                self.v.append(quantize_sqrtv(z))
            else:
                self.m.append(z)
                self.v.append(z.clone())

    def moments(self) -> dict:
        return {"m": self.m, "v": self.v}

    def state_bytes(self) -> int:
        """Bytes of the stored moments."""
        total = 0
        for entry in self.m + self.v:
            for t in (entry.values() if isinstance(entry, dict)
                      else (entry,)):
                total += t.numel() * t.element_size()
        return total

    @torch.no_grad()
    def step(self, grads, gates=None):
        lr = self.schedule(self.count)
        self.count += 1
        # bias corrections as the JAX package computes them (float32
        # powers), held on each device as tensors
        c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        scalars = {}
        gates = gates or [None] * len(self.params)
        for i, (p, g, gate) in enumerate(zip(self.params, self.clip(grads),
                                             gates)):
            dev = p.device
            if dev not in scalars:
                scalars[dev] = (c1.to(dev), c2.to(dev))
            d1, d2 = scalars[dev]
            g32 = g.float()
            q = self.quantized(p)
            if q:
                m = dequantize(self.m[i], p.shape)
                sv = dequantize_sqrtv(self.v[i], p.shape)
                v = sv * sv
            else:
                m, v = self.m[i], self.v[i]
            m = _fma(g32, self._1mb1, m * self.b1)
            v = _fma(g32 * (1.0 - self.b2), g32, v * self.b2)
            u = (m / d1) / (_sqrt(v / d2) + self.eps)
            if q:
                self.m[i], self.v[i] = quantize(m), quantize_sqrtv(_sqrt(v))
            else:
                self.m[i], self.v[i] = m, v
            if p.dtype == torch.float32:
                u = _fma(p, self._wd, u)
            else:
                u = u + p * self.weight_decay
            if gate is not None:
                u = u * gate
            p.copy_(p + u * (-lr))
