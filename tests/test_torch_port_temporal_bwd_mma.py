"""The arithmetic of K5's tensor-core backward
(csrc/temporal_attention_bwd.cu) emulated in plain PyTorch on the CPU,
its stage plan at every clip K3 takes, and the packing of its call.

On the card each (pixel, head) pair's S = Q K^T and dP = dO V^T run on
mma.sync as K3's S (bf16: f32 products and sums; fp32: every product at
3xTF32, each sum over d taken 64 columns at a time from zero), w =
softmax(S * scale) in base 2, delta = rowsum(w * dP), ds = w (dP -
delta) scale, then dV = w^T dO, dQ = ds K, dK = ds^T Q over the frames:
bf16 with w and ds split into bf16 hi + lo (both products taken), fp32 at
3xTF32. Here the same formulas run at small (F, N, H, d) on fused (F, N,
3P) views and must stay within the limits the card holds K5 to against
`temporal_attention_bwd_plain` (bf16 per output normwise <= 2^-10 and
largest error <= 2^-6 max|plain|; fp32 1e-5 + 1e-5 |plain|), and in fp32
within the port's 5e-5 of the JAX package's backward (its Pallas
`_bwd_kernel_call` in interpret mode; at 32 frames its XLA reference's
vjp). w and ds rounded to bf16 alone, or every fp32 product at 1xTF32,
must miss those limits, so the limits tell them apart.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_tf32x3 import mm
from video_style_transfer_tpu.ops import temporal_attention as jta
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import temporal_attention as tta

SHAPES = [(8, 24, 2, 40), (32, 6, 2, 160), (2, 16, 2, 16), (5, 12, 3, 24)]
BF16_LIMITS = (2 ** -10, 2 ** -6)  # normwise; largest, of max|plain|
F32_TOL = (1e-5, 1e-5)             # absolute + relative
JAX_TOL = 5e-5
CHUNK = 64  # d columns of S and dP summed from zero (fp32)
LOG2E = math.log2(math.e)


def emulated(q, k, v, do, scale, passes=3, split=True):
    """K5's arithmetic: q, k, v (F, N, H, d), do (F, N, H*d) -> dq, dk,
    dv (F, N, H, d) in q's dtype. passes=1: fp32 products at 1xTF32;
    split=False: bf16 w and ds rounded once, no lo part."""
    f, n, h, d = q.shape
    qh, kh, vh = (t.permute(1, 2, 0, 3).float() for t in (q, k, v))
    oh = do.reshape(f, n, h, d).permute(1, 2, 0, 3).float()
    bf16 = q.dtype == torch.bfloat16

    def scores(a, b):
        if bf16:
            return a @ b.transpose(-1, -2)
        return sum(mm(a[..., c:c + CHUNK], b[..., c:c + CHUNK]
                      .transpose(-1, -2), passes) for c in range(0, d, CHUNK))

    def product(a, b):
        if not bf16:
            return mm(a, b, passes)
        hi = a.to(torch.bfloat16).float()
        out = hi @ b
        if split:
            out = out + (a - hi).to(torch.bfloat16).float() @ b
        return out
    s, dp = scores(qh, kh), scores(oh, vh)
    x = s * (scale * LOG2E)
    p = torch.exp2(x - x.amax(-1, keepdim=True))
    w = p / p.sum(-1, keepdim=True)
    ds = w * (dp - (w * dp).sum(-1, keepdim=True)) * scale
    dq = product(ds, kh)
    dk = product(ds.transpose(-1, -2), qh)
    dv = product(w.transpose(-1, -2), oh)
    return tuple(t.permute(2, 0, 1, 3).to(q.dtype) for t in (dq, dk, dv))


def _inputs(shape, dtype, seed=0):
    """Seeded q, k, v ((F, N, H, d) views of one fused (F, N, 3P)
    projection, as the motion module makes them) and dO (F, N, P)."""
    f, n, h, d = shape
    rng = np.random.default_rng(seed)
    qkv, do = (torch.from_numpy(rng.standard_normal(
        (f, n, c * h * d)).astype(np.float32)).to(dtype) for c in (3, 1))
    return [t.unflatten(-1, (h, d)) for t in qkv.split(h * d, -1)] + [do]


def _passes(outs, refs):
    """Whether outs hold the card's limits against refs, each output on
    its own (chip_smoke.py's bwd_check)."""
    for o, r in zip(outs, refs):
        diff, r = o.double() - r.double(), r.double()
        if o.dtype == torch.bfloat16:
            if (diff.norm() > BF16_LIMITS[0] * r.norm()
                    or diff.abs().max() > BF16_LIMITS[1] * r.abs().max()):
                return False
        elif (diff.abs() - F32_TOL[1] * r.abs()).max() > F32_TOL[0]:
            return False
    return True


def _jax(q, k, v, do, scale):
    """The JAX package's backward on the same fp32 inputs (per-frame (P,
    N) arrays) -> dq, dk, dv as (F, N, H, d): `_bwd_kernel_call` (Pallas,
    interpret mode), or at 32 frames, whose F^2 unrolled steps take
    minutes to interpret, the vjp of its XLA reference
    (`temporal_attention_frames(impl="xla")`)."""
    f, n, h, d = q.shape

    def frames(t):
        a = t.reshape(f, n, h * d).numpy()
        return [jnp.asarray(a[i].T) for i in range(f)]
    if f < 32:
        outs = jta._bwd_kernel_call(frames(q), frames(k), frames(v),
                                    frames(do), num_heads=h, scale=scale,
                                    block_n=n)
    else:
        _, vjp = jax.vjp(lambda *a: list(jta.temporal_attention_frames(
            *a, num_heads=h, scale=scale, impl="xla")),
            frames(q), frames(k), frames(v))
        outs = vjp(frames(do))
    return [torch.from_numpy(np.stack([np.asarray(x).T for x in o]))
            .reshape(f, n, h, d) for o in outs]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_k5_emulation_holds_the_limits(shape, dtype):
    q, k, v, do = _inputs(shape, dtype)
    scale = shape[3] ** -0.5
    got = emulated(q, k, v, do, scale)
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dtype
    assert _passes(got, tta.temporal_attention_bwd_plain(q, k, v, do, scale))
    if dtype == torch.float32:
        for g, w in zip(got, _jax(q, k, v, do, scale)):
            assert (g - w).abs().max().item() <= JAX_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_k5_single_rounding_misses_the_limits(shape):
    # bf16 w and ds rounded once (~2.7e-3 normwise here) and fp32 at
    # 1xTF32 (~1e-3 past the limit): both refused
    for dtype, kw in ((torch.bfloat16, {"split": False}),
                      (torch.float32, {"passes": 1})):
        q, k, v, do = _inputs(shape, dtype)
        scale = shape[3] ** -0.5
        plain = tta.temporal_attention_bwd_plain(q, k, v, do, scale)
        assert not _passes(emulated(q, k, v, do, scale, **kw), plain)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_k5_plan_takes_every_clip_k3_takes(itemsize):
    # for every F in 1..32 and d % 8 == 0 up to 1216: the wrapper's one
    # rule (pair_fits, K3's) admits the clip, and K5's plan then fits a
    # block: TMA boxes of at most 256 elements and whole 16-byte rows, the
    # stage's columns a multiple of 8 covering d, and its stages, 16 bytes
    # of barriers each and the zero row in 227 KB
    admitted = 0
    for f in range(1, tta.MAX_FRAMES + 1):
        for d in range(8, 1217, 8):
            if not tta.pair_fits(f, d, itemsize):
                # past K3's rule: 3 F d bytes over a block
                assert 3 * f * d * itemsize > tta.MAX_BLOCK_SMEM
                continue
            admitted += 1
            for heads, n in ((8, 16384), (1, 1), (3, 7)):
                ldp, cols, chunks, hb, tn, stages = tta.bwd_plan(
                    f, d, itemsize, heads, n)
                assert ldp <= tta.MAX_BOX and ldp * itemsize % 16 == 0
                assert cols % 8 == 0 and chunks * cols >= d
                assert heads % hb == 0 and 1 <= tn <= max(n, 1)
                if chunks == 1:
                    assert cols == d and ldp >= d
                else:
                    assert (cols, hb, tn) == (ldp, 1, 1)
                stage = 4 * (-(-hb * tn * f * ldp * itemsize // 128) * 128)
                assert 1 <= stages <= tta.BWD_MAX_STAGES
                assert stages * (stage + 16) + 16 <= tta.MAX_BLOCK_SMEM
    # the widths where the parent kernel refused what K3 took (F = 32:
    # fp32 d = 352-600, bf16 d = 704-1208) are among them
    widest = 600 if itemsize == 4 else 1208
    assert tta.pair_fits(32, widest, itemsize)
    assert not tta.pair_fits(32, widest + 8, itemsize)
    assert admitted > 0


def test_k5_plan_at_the_path_shapes():
    # stage-2 motion levels 0-2 at 8 frames: whole pairs, LDP an odd count
    # of 16-byte chunks; 32 frames at the widest heads: column chunks
    assert tta.bwd_plan(8, 40, 2, 8, 16384) == (40, 40, 1, 8, 1, 8)
    assert tta.bwd_plan(8, 40, 4, 8, 16384) == (44, 40, 1, 4, 1, 8)
    assert tta.bwd_plan(8, 80, 2, 8, 4096) == (88, 80, 1, 4, 1, 8)
    assert tta.bwd_plan(8, 160, 2, 8, 1024) == (168, 160, 1, 2, 1, 8)
    assert tta.bwd_plan(2, 40, 4, 8, 16384)[:5] == (44, 40, 1, 8, 3)
    assert tta.bwd_plan(32, 600, 4, 2, 1024)[:5] == (72, 72, 9, 1, 1)
    assert tta.bwd_plan(32, 1208, 2, 2, 1024)[:5] == (136, 136, 9, 1, 1)


def test_k5_call_packing_matches_c_struct():
    # the wrapper's four packed parts make csrc/temporal_attention_bwd.cu's
    # TABwdCall: eight pointers, nine strides, six ints, the plan's six,
    # the scale and its pad; and the launcher's block limits are the plan's
    src = (cuda_build.CSRC / "temporal_attention_bwd.cu").read_text()
    got = re.search(r"offsetof\(vst::TABwdCall, ldp\) == (\d+) &&\s*"
                    r"offsetof\(vst::TABwdCall, scale\) == (\d+) &&\s*"
                    r"sizeof\(vst::TABwdCall\) == (\d+)", src)
    assert got, "temporal_attention_bwd.cu states TABwdCall's layout"
    head = tta._BWD_POINTERS.size + tta._LAYOUT.size
    assert (head, head + tta._BWD_PLAN.size,
            head + tta._BWD_PLAN.size + tta._SCALE.size) == tuple(
                map(int, got.groups()))
    for name, value in (("MAX_SMEM", tta.MAX_BLOCK_SMEM),
                        ("MAX_BOX", tta.MAX_BOX)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert cuda_build.SIGNATURES["vst_temporal_attention_bwd"] == [
        cuda_build._P]
