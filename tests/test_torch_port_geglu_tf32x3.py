"""The arithmetic of K2's fp32 route (csrc/geglu.cu: geglu_f32_kernel,
TF32 wgmma at 3xTF32) emulated in plain PyTorch on the CPU, and the
wrapper's limits.

The card's kernel splits each fp32 operand a into hi = rna_tf32(a) and
lo = rna_tf32(a - hi) and takes every product as lo*hi + hi*lo + hi*hi on
the tensor cores, 8 K values an instruction; each stage's K values
(RESTART = 32, twelve products) are summed from zero, its lo*hi and
hi*lo products before its hi*hi ones, and added to the tile's total in
f32, then the bias and the erf5 gate run in f32. Here the same
walk runs with every instruction's sum taken in f32, at K2's three (C,
inner) pairs with an M that leaves a tail in the kernel's 128-row tiles,
and must stay within the fp32 tolerance that the card holds the kernel
to against `geglu_plain` (1e-5). The same walk with every product at
1xTF32 (hi*hi alone) must miss it. The emulation is also held against
the JAX package's Pallas route (interpret mode) at the port's 2e-5.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_style_transfer_tpu.ops import geglu as jgeglu
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import geglu as tgeglu

RESTART = 32   # K values whose products the kernel sums from zero
STEP = 8       # K values a TF32 wgmma
TOL = 1e-5     # the card's fp32 limit against geglu_plain, absolute


def rna_tf32(x):
    """fp32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero, as csrc/mma_sync.cuh's rna_tf32 rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def geglu_emulated(x, w, b, passes):
    """K2's fp32 walk: x (M, C), w (2 inner, C), b (2 inner,) -> (M,
    inner). Each restart's products summed from zero, one 8-wide step at
    a time: with 3 passes its lo*hi and hi*lo ones first, then its hi*hi
    ones; with 1 its hi*hi ones alone. The restarts added in f32, then
    (h + b_h) * erf5(g + b_g) in f32."""
    xh, wh = rna_tf32(x), rna_tf32(w)
    xl, wl = rna_tf32(x - xh), rna_tf32(w - wh)
    total = torch.zeros(x.shape[0], w.shape[0])
    small = ((xl, wh), (xh, wl)) if passes == 3 else ()
    for k0 in range(0, x.shape[1], RESTART):
        part = torch.zeros_like(total)
        steps = [slice(s, s + STEP)
                 for s in range(k0, min(k0 + RESTART, x.shape[1]), STEP)]
        for terms in (small, ((xh, wh),)):
            for k in steps:
                for a, bt in terms:
                    part = part + a[:, k] @ bt[:, k].T
        total = total + part
    inner = w.shape[0] // 2
    y = total + b
    return y[:, :inner] * tgeglu._gelu_exact(y[:, inner:])


def _inputs(m, c, inner, seed=0):
    # the card check's scales: x of unit variance, W of 1/sqrt(C), b 0.1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, c)).astype(np.float32)
    w = (rng.standard_normal((2 * inner, c)) * c ** -0.5).astype(np.float32)
    b = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, w, b))


# K2's (C, inner) pairs on the paths: spatial level 2, level 1, motion
# level 0; M = 130 leaves a 2-row tail after one 128-row tile
SHAPES = [(130, 1280, 5120), (130, 640, 2560), (130, 320, 1280)]


def test_restart_length_is_the_kernels():
    # the emulation restarts where the kernel does (F32Cfg: RESTART K
    # steps of 8, a stage of KS K values)
    src = (cuda_build.CSRC / "geglu.cu").read_text()
    tiles = re.search(r"struct F32Cfg \{\s*static constexpr int BM = (\d+), "
                      r"BN = (\d+), KS = (\d+);", src)
    restart = re.search(r"static constexpr int RESTART = (\d+);", src)
    assert tiles and restart, "geglu.cu states F32Cfg's tiles and restart"
    assert STEP * int(restart.group(1)) == RESTART
    assert int(tiles.group(3)) % RESTART == 0


@pytest.mark.parametrize("m,c,inner", SHAPES)
def test_3xtf32_holds_the_fp32_tolerance(m, c, inner):
    x, w, b = _inputs(m, c, inner)
    got = geglu_emulated(x, w, b, passes=3)
    ref = tgeglu.geglu_plain(x, w, b, "erf5")
    assert got.shape == (m, inner)
    assert (got - ref).abs().max().item() <= TOL


@pytest.mark.parametrize("m,c,inner", SHAPES)
def test_1xtf32_misses_the_fp32_tolerance(m, c, inner):
    # hi*hi alone: the tolerance must refuse it
    x, w, b = _inputs(m, c, inner)
    got = geglu_emulated(x, w, b, passes=1)
    ref = tgeglu.geglu_plain(x, w, b, "erf5")
    assert (got - ref).abs().max().item() > 10 * TOL


def test_3xtf32_matches_jax_route():
    # the JAX package's K2 (interpret mode on the CPU) at the port's 2e-5,
    # at a tiny shape whose C spans three stages of 32 (the last one
    # partial)
    m, c, inner = 64, 72, 256
    x, w, b = _inputs(m, c, inner, seed=3)
    assert c % 32 and c > 64
    want = jgeglu.geglu_projection(jnp.asarray(x.numpy()),
                                   jnp.asarray(w.numpy().T.copy()),
                                   jnp.asarray(b.numpy()))
    got = geglu_emulated(x, w, b, passes=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_route_names_the_kernel():
    assert tgeglu.route(torch.bfloat16) == "wgmma"
    assert tgeglu.route(torch.float32) == "tf32x3"
    assert set(tgeglu.ROUTE_LAUNCHES) == {"wgmma", "tf32x3"}
    with pytest.raises(TypeError):
        tgeglu.route(torch.float16)


class _FakeCuda:
    """What `_check_layout` reads of a contiguous, aligned CUDA tensor of
    `shape` and `dtype`, without a card."""

    is_cuda = True
    device = "cuda:0"

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 1 << 20


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,ok", [
    (64 * 65535 + 1, True),   # past the old fp32 grid's 65535 row blocks
    (524288 * 16, True),      # 16 clips' motion level 0 at once
    (2 ** 31 - 1, True),
    (2 ** 31, False),         # M must fit an int
    (0, False)])
def test_check_layout_row_limits(dtype, m, ok):
    # both kernels are persistent (one block an SM walks the tiles), so
    # fp32 no longer refuses M past 65535 64-row blocks; M must still be a
    # positive int
    c, inner = 320, 1280
    args = (_FakeCuda((m, c), dtype), _FakeCuda((2 * inner, c), dtype),
            _FakeCuda((2 * inner,), dtype))
    if ok:
        tgeglu._check_layout(*args)
    else:
        with pytest.raises(ValueError):
            tgeglu._check_layout(*args)
