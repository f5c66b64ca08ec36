"""The arithmetic of K3's tensor-core forward (csrc/temporal_attention.cu)
emulated in plain PyTorch on the CPU, and the packing of its call.

On the card each (pixel, head) pair's S = Q K^T and O = P V run on
mma.sync. bf16: f32 products and sums, the unnormalised P = exp2(S *
scale * log2e - rowmax) rounded to bf16 for P V, and O scaled by the f32
1/rowsum of the unrounded P afterwards (the plain version rounds the
normalised weights instead). fp32: every product at 3xTF32 (each operand
split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), lo*hi + hi*lo +
hi*hi), S summed over d 64 columns at a time, each chunk from zero. Here
the same formulas run at (F, N, H, d) = (16, 24, 2, 40), (32, 8, 2, 160)
and (8, 16, 2, 16) on fused (F, N, 3P) views, and must stay within the
tolerances the card holds K3 to against `temporal_attention_plain` (bf16
2e-2 + 2^-6 * |plain|, fp32 1e-5 absolute) and against the JAX package's
Pallas kernel `_fwd_kernel_call` in interpret mode (bf16 the same, fp32
the port's 2e-5). The fp32 walk with every product at 1xTF32 (hi*hi
alone) must miss 1e-5, so the tolerance tells the two apart.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_tf32x3 import mm
from video_style_transfer_tpu.ops import temporal_attention as jta
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import temporal_attention as tta

SHAPES = [(16, 24, 2, 40), (32, 8, 2, 160), (8, 16, 2, 16)]
TOL = {torch.bfloat16: (2e-2, 2 ** -6), torch.float32: (1e-5, 0.0)}
TOL_JAX_F32 = 2e-5
CHUNK = 64  # d columns of S summed from zero (fp32)
LOG2E = math.log2(math.e)


def emulated(q, k, v, scale, passes=3):
    """K3's arithmetic: q, k, v (F, N, H, d) -> (F, N, H*d) in q's
    dtype."""
    f, n, h, d = q.shape
    qh, kh, vh = (t.permute(1, 2, 0, 3).float() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        s = qh @ kh.transpose(-1, -2)
    else:
        s = sum(mm(qh[..., c:c + CHUNK],
                   kh[..., c:c + CHUNK].transpose(-1, -2), passes)
                for c in range(0, d, CHUNK))
    x = s * (scale * LOG2E)
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    inv = 1.0 / p.sum(-1, keepdim=True)
    if q.dtype == torch.bfloat16:
        o = (p.to(torch.bfloat16).float() @ vh) * inv
    else:
        o = mm(p, vh, passes) * inv
    return o.permute(2, 0, 1, 3).reshape(f, n, h * d).to(q.dtype)


def _inputs(shape, dtype, seed=0):
    """Seeded q, k, v: (F, N, H, d) views of one fused (F, N, 3P)
    projection, as the motion module makes them."""
    f, n, h, d = shape
    qkv = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (f, n, 3 * h * d)).astype(np.float32)).to(dtype)
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1)]


def _excess(out, ref, tol):
    """Largest |out - ref| - rtol*|ref| - atol (<= 0 within `tol`)."""
    atol, rtol = tol
    return ((out.float() - ref.float()).abs()
            - rtol * ref.float().abs()).max().item() - atol


def _jax(q, k, v, scale):
    """JAX `_fwd_kernel_call` (Pallas, interpret mode) on the same inputs:
    per-frame (P, N) arrays in q's dtype -> (F, N, P) f32."""
    f, n, h, d = q.shape
    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32

    def frames(t):
        a = t.float().reshape(f, n, h * d).numpy()
        return [jnp.asarray(a[i].T).astype(dt) for i in range(f)]
    out = jta._fwd_kernel_call(frames(q), frames(k), frames(v), num_heads=h,
                               scale=scale, block_n=n)
    return torch.from_numpy(np.stack(
        [np.asarray(o.astype(jnp.float32)).T for o in out]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_emulation_holds_the_tolerances(shape, dtype):
    q, k, v = _inputs(shape, dtype)
    scale = shape[3] ** -0.5
    got = emulated(q, k, v, scale)
    assert got.shape == (shape[0], shape[1], shape[2] * shape[3])
    plain = tta.temporal_attention_plain(q, k, v, scale)
    assert _excess(got, plain, TOL[dtype]) <= 0
    jax_tol = TOL[dtype] if dtype == torch.bfloat16 else (TOL_JAX_F32, 0.0)
    assert _excess(got, _jax(q, k, v, scale), jax_tol) <= 0


@pytest.mark.parametrize("shape", SHAPES)
def test_k3_1xtf32_misses_the_fp32_tolerance(shape):
    q, k, v = _inputs(shape, torch.float32)
    scale = shape[3] ** -0.5
    plain = tta.temporal_attention_plain(q, k, v, scale)
    assert _excess(emulated(q, k, v, scale, passes=1), plain,
                   TOL[torch.float32]) > 0


def test_k3_call_packing_matches_c_struct():
    # the wrapper's three packed parts make csrc/temporal_attention.cu's
    # TACall: five pointers, nine strides, six ints, the scale and its pad
    src = (cuda_build.CSRC / "temporal_attention.cu").read_text()
    got = re.search(r"offsetof\(vst::TACall, scale\) == (\d+) &&\s*"
                    r"sizeof\(vst::TACall\) == (\d+)", src)
    assert got, "temporal_attention.cu states TACall's layout"
    head = tta._POINTERS.size + tta._LAYOUT.size
    assert (head, head + tta._SCALE.size) == tuple(map(int, got.groups()))
    assert cuda_build.SIGNATURES["vst_temporal_attention_fwd"] == [
        cuda_build._P]
