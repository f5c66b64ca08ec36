"""The arithmetic of K1's and K4's 3xTF32 route (fp32 at d = 64,
csrc/flash_attention_tf32.cu) emulated in plain PyTorch on the CPU, and
K3's shared-memory bound.

The card's kernels split each fp32 operand x into hi = rna_tf32(x) and
lo = rna_tf32(x - hi) and take every product as lo*hi + hi*lo + hi*hi on
the tensor cores; each 64-wide tile's products are summed from zero and
added to the running sums in f32. Here the same formulas run with every
product emulated that way, walking the kernels' 64-row tiles, at a shape
with q and kv tails, and must stay within the fp32 tolerances that the
card holds the kernels to against `flash_attention_plain` and
`flash_attention_bwd_plain` (out and lse 1e-5; dq, dk, dv 1e-5 + 1e-5 *
|plain|). The same walk with every product at 1xTF32 (hi*hi alone) must
miss them, so the tolerances can tell the two apart. The emulated
forward is also held against the JAX package's Pallas route (interpret
mode) at the port's 2e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_style_transfer_tpu.ops import flash_attention as jfa
from video_style_transfer_tpu_torch.ops import flash_attention as tfa
from video_style_transfer_tpu_torch.ops import temporal_attention as tta

TILE = 64          # the kernels' q and kv tiles
TOL_FWD = 1e-5     # out and lse, absolute
TOL_BWD = (1e-5, 1e-5)  # dq, dk, dv: absolute + relative
LOG2E = math.log2(math.e)


def rna_tf32(x):
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as cvt.rna.tf32.f32 rounds: the magnitude bits
    plus half of the 13 dropped bits, then the dropped bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a, b, passes):
    """a @ b in f32 with every product at 3xTF32 (lo*hi and hi*lo first,
    then hi*hi) or 1xTF32 (hi*hi)."""
    ah, bh = rna_tf32(a), rna_tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = rna_tf32(a - ah), rna_tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def fwd_emulated(q, k, v, scale, passes):
    """K1's walk: online softmax over 64-key tiles in log2 units, each
    tile's P V summed apart and added to the rescaled O. q: (B, Sq, H, D);
    k, v (B, Sk, H, D) -> out (B, Sq, H*D), lse (B, H, Sq)."""
    b, sq, h, d = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    sl2 = scale * LOG2E
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros(b, h, sq)
    o = torch.zeros(b, h, sq, d)
    for k0 in range(0, k.shape[1], TILE):
        s = mm(qh, kh[:, :, k0:k0 + TILE].transpose(-1, -2), passes) * sl2
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + mm(p, vh[:, :, k0:k0 + TILE], passes)
        m = m_new
    out = (o / l[..., None]).permute(0, 2, 1, 3).reshape(b, sq, h * d)
    return out, (m + torch.log2(l)) / LOG2E


def bwd_emulated(q, k, v, o, lse, do, scale, passes):
    """K4's two kernels: p from the saved lse, dp, ds; dq summed over kv
    tiles (the dq kernel's walk), dk and dv over q tiles (the dk/dv
    kernel's), each tile's products apart."""
    b, sq, h, d = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    doh = do.reshape(b, sq, h, d).permute(0, 2, 1, 3)
    delta = tfa.flash_attention_bwd_delta_plain(o, do, h)
    s = mm(qh, kh.transpose(-1, -2), passes)
    p = torch.exp2(s * (scale * LOG2E) - (lse * LOG2E)[..., None])
    dp = mm(doh, vh.transpose(-1, -2), passes)
    ds = p * (dp - delta[..., None]) * scale
    dq = sum(mm(ds[..., k0:k0 + TILE], kh[:, :, k0:k0 + TILE], passes)
             for k0 in range(0, k.shape[1], TILE))
    dk = sum(mm(ds[:, :, q0:q0 + TILE].transpose(-1, -2),
                qh[:, :, q0:q0 + TILE], passes)
             for q0 in range(0, sq, TILE))
    dv = sum(mm(p[:, :, q0:q0 + TILE].transpose(-1, -2),
                doh[:, :, q0:q0 + TILE], passes)
             for q0 in range(0, sq, TILE))
    return tuple(t.permute(0, 2, 1, 3).contiguous() for t in (dq, dk, dv))


def _inputs(seed=0, b=2, s=300, h=2, d=64):
    # 300 = 4 x 64 + 44: a q tail and a kv tail in every walk
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d))
                             .astype(np.float32)) for _ in range(4)]


def _readings(passes):
    """Largest excess over the fp32 tolerances of the emulated forward
    (out, lse) and backward (dq, dk, dv) against the plain versions."""
    q, k, v, do4 = _inputs()
    scale = 64 ** -0.5
    do = do4.reshape(do4.shape[0], do4.shape[1], -1)
    out, lse = fwd_emulated(q, k, v, scale, passes)
    ref_out, ref_lse = tfa.flash_attention_plain(q, k, v, scale)
    fwd = max((out - ref_out).abs().max().item(),
              (lse - ref_lse).abs().max().item()) - TOL_FWD
    # both backwards from the emulated forward's out and lse, as the card
    # holds K4 against the plain backward on K1's outputs
    got = bwd_emulated(q, k, v, out, lse, do, scale, passes)
    ref = tfa.flash_attention_bwd_plain(q, k, v, out, lse, do, scale)
    bwd = max(((a.double() - r.double()).abs()
               - TOL_BWD[1] * r.double().abs()).max().item()
              for a, r in zip(got, ref)) - TOL_BWD[0]
    return fwd, bwd, (out, lse)


def test_rna_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10,
                         3.0, -0.0], dtype=torch.float32)
    assert torch.equal(rna_tf32(x), want)
    # hi + lo holds x to ~2^-22 of its size; hi alone to 2^-11
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)
                         .astype(np.float32))
    hi = rna_tf32(y)
    lo = rna_tf32(y - hi)
    assert ((y - hi).abs() <= 2 ** -11 * y.abs()).all()
    assert ((y - hi - lo).abs() <= 2 ** -21 * y.abs()).all()
    assert (rna_tf32(hi) == hi).all() and (rna_tf32(lo) == lo).all()


def test_3xtf32_holds_the_fp32_tolerances():
    fwd, bwd, (out, lse) = _readings(passes=3)
    assert fwd <= 0 and bwd <= 0, (fwd, bwd)
    # and the JAX package's route at the port's 2e-5 (interpret mode)
    q, k, v, _ = _inputs()
    b, s, h, d = q.shape
    jout, jlse = jfa._flash_fwd_bs_hd(
        *(jnp.asarray(t.numpy().reshape(b, s, h * d)) for t in (q, k, v)),
        num_heads=h, scale=d ** -0.5, block_q=s, block_k=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(
        b, s, h * d), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(
        b, h, s), atol=2e-5, rtol=0)


def test_1xtf32_misses_the_fp32_tolerances():
    # the same walk with hi*hi alone: the tolerances must refuse it, in
    # the forward and in the backward
    fwd, bwd, _ = _readings(passes=1)
    assert fwd > 0 and bwd > 0, (fwd, bwd)


@pytest.mark.parametrize("frames,d,itemsize,fits", [
    (32, 160, 4, True),    # fp32 --num_frames 32 at motion level 2: 60 KB
    (26, 160, 4, True),    # the first fp32 clip length past 48 KB
    (32, 160, 2, True),
    (16, 40, 4, True),
    (32, 600, 4, True),    # 225 KB
    (32, 608, 4, False),   # 228 KB: past a block's 227 KB
])
def test_temporal_attention_pair_fits_a_block(frames, d, itemsize, fits):
    # K3 takes a (pixel, head) pair whose F x d q, k and v fit one block's
    # shared memory (227 KB on Hopper), no longer 48 KB
    assert tta.pair_fits(frames, d, itemsize) is fits
