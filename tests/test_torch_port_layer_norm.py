"""K7 of the PyTorch port: the plain version of the one-pass LayerNorm
against the JAX package's ``ops.layer_norm.layer_norm`` (its Pallas
kernel in interpret mode where its gate passes the shape, its reference
formula where not) and ``_reference``, on the CPU.

Tolerances: f32 2e-5 (only the order of the f32 sums differs). bf16: both
sides keep f32 inside and round once, so they agree to 2e-5 except where
an f32 difference in the last bits crosses a bf16 rounding boundary: such
an element may differ by one output ulp (2^-7 relative), and at most one
element in a thousand may do so. Gradients 5e-5 against ``jax.grad``
and ``jax.vjp`` in f32, one bf16 ulp of the largest entry in bf16. The
models' ``layer_norm`` goes through this module and is held against the
JAX package's ``models/layers.py:layer_norm``, also with f32 parameters
beside bf16 activations.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.models import layers as jlayers
from video_style_transfer_tpu.ops import layer_norm as jln
from video_style_transfer_tpu_torch.models import layers as tlayers
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import layer_norm as tln


def _inputs(shape, seed=0, shift=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    b = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, s, b


@pytest.fixture(autouse=True)
def no_library(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("CPU call reached the CUDA kernel library")
    monkeypatch.setattr(cuda_build, "library", refuse)


# shapes the JAX gate (rows % 8 == 0 and C % 128 == 0) sends to its
# kernel, and ones it sends to its reference formula
SHAPES = [((32, 128), "kernel"), ((4, 64, 256), "kernel"),
          ((520, 384), "kernel"), ((10, 24), "reference"),
          ((2, 77, 768), "reference"), ((16, 320), "reference")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,route", SHAPES,
                         ids=[f"{s}-{r}" for s, r in SHAPES])
def test_plain_matches_jax(shape, route, dtype):
    x, s, b = _inputs(shape)
    rows = int(np.prod(shape[:-1]))
    assert (rows % 8 == 0 and shape[-1] % 128 == 0) == (route == "kernel")
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts, tb = torch.from_numpy(s), torch.from_numpy(b)
    got = tln.layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert torch.equal(got, tln.layer_norm_reference(tx, ts, tb))
    got = got.float().numpy()
    for want in (jln.layer_norm(jx, jnp.asarray(s), jnp.asarray(b)),
                 jln._reference(jx, jnp.asarray(s), jnp.asarray(b), 1e-5)):
        want = np.asarray(want.astype(jnp.float32))
        diff = np.abs(got - want)
        if dtype == "float32":
            assert diff.max() <= 2e-5
        else:
            assert (diff <= 2e-5 + 2.0 ** -7 * np.abs(want)).all()
            assert (diff > 2e-5).mean() <= 1e-3


def test_eps_is_threaded():
    x, s, b = _inputs((16, 128), seed=4)
    got = tln.layer_norm(*map(torch.from_numpy, (x, s, b)), eps=1e-3)
    want = jln.layer_norm(*map(jnp.asarray, (x, s, b)), eps=1e-3)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5
    other = tln.layer_norm(*map(torch.from_numpy, (x, s, b)))
    assert np.abs(got.numpy() - other.numpy()).max() > 1e-4


def test_large_offset_does_not_cancel():
    # mean^2 >> var: a one-pass E[x^2] - mean^2 would be off by O(1)
    x, s, b = _inputs((16, 128), seed=3, shift=100.0, scale=0.01)
    got = tln.layer_norm(*map(torch.from_numpy, (x, s, b))).numpy()
    x64 = x.astype(np.float64)
    m = x64.mean(-1, keepdims=True)
    v = ((x64 - m) ** 2).mean(-1, keepdims=True)
    want = (x64 - m) / np.sqrt(v + 1e-5) * s + b
    assert np.abs(got - want).max() <= 5e-3


@pytest.mark.parametrize("shape", [(32, 128), (10, 24)])
def test_gradients_match_jax(shape):
    x, s, b = _inputs(shape, seed=5)
    cot = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jln.layer_norm(*a) * cot), argnums=(0, 1, 2))(
            *map(jnp.asarray, (x, s, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
    out = tln.layer_norm(*leaves)
    assert out.grad_fn is not None
    (out * torch.from_numpy(cot)).sum().backward()
    for leaf, ref in zip(leaves, want):
        assert np.abs(leaf.grad.numpy() - np.asarray(ref)).max() <= 5e-5


def test_backward_skips_inputs_that_need_no_gradient():
    x, s, b = map(torch.from_numpy, _inputs((8, 128), seed=7))
    x.requires_grad_()
    tln.layer_norm(x, s, b).sum().backward()
    assert x.grad is not None and s.grad is None and b.grad is None


def test_models_go_through_the_k7_module(monkeypatch):
    # every LayerNorm of the models goes through K7's module (the kernel
    # on the card, its plain version here) and equals the JAX package's
    # models/layers.py:layer_norm
    calls = []
    real = tln.layer_norm

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tln, "layer_norm", counted)
    x, s, b = _inputs((5, 24), seed=8)
    got = tlayers.layer_norm({"weight": torch.from_numpy(s),
                              "bias": torch.from_numpy(b)},
                             torch.from_numpy(x))
    assert calls == [(5, 24)]
    want = jlayers.layer_norm({"scale": jnp.asarray(s),
                               "bias": jnp.asarray(b)}, jnp.asarray(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5


@pytest.mark.parametrize("shape", [(4, 16, 320), (2, 77, 1280), (7, 24)])
def test_models_f32_affine_beside_bf16_x_match_jax(shape):
    # parameters held in f32 beside bf16 activations are applied in f32,
    # as the JAX formula's astype(float32) does, not rounded to bf16 first
    x, s, b = _inputs(shape, seed=9)
    xb = torch.from_numpy(x).bfloat16()
    got = tlayers.layer_norm({"weight": torch.from_numpy(s),
                              "bias": torch.from_numpy(b)}, xb)
    assert got.dtype == torch.bfloat16
    want = jlayers.layer_norm(
        {"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
        jnp.asarray(x).astype(jnp.bfloat16))
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    assert (diff <= 2e-5 + 2.0 ** -7 * np.abs(want)).all()
    assert (diff > 2e-5).mean() <= 1e-3


# (x dtype, affine dtype): the pairs the paths hold, and a bf16 x beside
# an f32 affine
GRAD_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("bfloat16", "float32")]


def _jax_vjp(x, s, b, cot, xdt, sdt):
    jx = jnp.asarray(x).astype(xdt)
    js, jb = jnp.asarray(s).astype(sdt), jnp.asarray(b).astype(sdt)
    _, vjp = jax.vjp(lambda *a: jlayers.layer_norm(
        {"scale": a[1], "bias": a[2]}, a[0]), jx, js, jb)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(cot).astype(xdt))]


def _assert_grads_close(got, want, dtype):
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        if dtype == "float32":
            assert np.abs(g - w).max() <= 5e-5 * max(scale, 1.0)
        else:
            # one bf16 ulp of the largest entry: the sums over rows (dscale,
            # dbias) and over the row (dx) are taken in another order
            assert np.abs(g - w).max() <= 2.0 ** -7 * scale


@pytest.mark.parametrize("xdt,sdt", GRAD_DTYPES)
@pytest.mark.parametrize("shape", [(6, 128), (2, 9, 320)])
def test_models_gradients_match_jax_vjp(shape, xdt, sdt):
    # the CPU's route: the plain formula's autograd
    x, s, b = _inputs(shape, seed=10)
    cot = np.random.default_rng(11).standard_normal(shape).astype(
        np.float32)
    leaves = [torch.from_numpy(x).to(getattr(torch, xdt)),
              torch.from_numpy(s).to(getattr(torch, sdt)),
              torch.from_numpy(b).to(getattr(torch, sdt))]
    leaves = [t.requires_grad_() for t in leaves]
    out = tlayers.layer_norm({"weight": leaves[1], "bias": leaves[2]},
                             leaves[0])
    out.backward(torch.from_numpy(cot).to(out.dtype))
    got = [t.grad.float().numpy() for t in leaves]
    assert [t.grad.dtype for t in leaves] == [t.dtype for t in leaves]
    _assert_grads_close(got, _jax_vjp(x, s, b, cot, xdt, sdt), xdt)


@pytest.mark.parametrize("xdt,sdt", [("float32", "float32"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("shape", [(6, 128), (2, 9, 320)])
def test_card_backward_route_matches_jax_vjp(shape, xdt, sdt):
    # the card's route, aten's native_layer_norm_backward on the saved
    # f32 statistics, run here on CPU tensors with the plain version's
    # statistics (the kernel's are held against those on the card, and
    # bf16 x with a bf16 affine there: aten's CPU kernel wants bf16
    # statistics for that pair, its CUDA kernel f32 ones)
    x, s, b = _inputs(shape, seed=12)
    cot = np.random.default_rng(13).standard_normal(shape).astype(
        np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    ts, tb = (torch.from_numpy(a).to(getattr(torch, sdt)) for a in (s, b))
    mean, rstd = tln.layer_norm_stats_reference(tx)
    assert mean.shape == rstd.shape == (tx.numel() // shape[-1], 1)
    got = tln.layer_norm_bwd(torch.from_numpy(cot).to(tx.dtype), tx, ts, tb,
                             mean, rstd)
    assert [g.dtype for g in got] == [tx.dtype, ts.dtype, tb.dtype]
    assert got[0].shape == tx.shape
    _assert_grads_close([g.float().numpy() for g in got],
                        _jax_vjp(x, s, b, cot, xdt, sdt), xdt)
    # only what is asked for: frozen parameters need dx alone
    dx, ds, db = tln.layer_norm_bwd(torch.from_numpy(cot).to(tx.dtype), tx,
                                    ts, tb, mean, rstd,
                                    need=(True, False, False))
    assert ds is None and db is None and torch.equal(dx, got[0])


def test_rows_per_block_and_warp_cover_the_sms():
    # 8 rows a block where every SM still gets one; fewer for small M
    assert tln.rows_per_block(32 * 1024, 132) == 8
    assert tln.rows_per_block(2048, 132) == 8
    assert tln.rows_per_block(1024, 132) == 4
    assert tln.rows_per_block(300, 132) == 2
    assert tln.rows_per_block(154, 132) == 1
    assert tln.rows_per_block(77, 132) == 1
    # the dscale / dbias kernel: about two blocks of 8 warps an SM
    assert tln.affine_rows_per_warp(8 * 16384, 132) == 63
    assert tln.affine_rows_per_warp(8 * 1024, 132) == 4
    assert tln.affine_rows_per_warp(7, 132) == 1
    # the packed calls: the C structs LayerNormCall and
    # LayerNormAffineGradCall are 88 bytes each
    assert tln._POINTERS.size + tln._LAYOUT.size == 88
    assert tln._AFFINE_CALL.size == 88


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_grads_round_once_to_the_affines_dtype(dtype):
    # dscale and dbias come out in the dtype asked for (the affine's),
    # rounded once from the f32 sums
    x, _, _ = _inputs((9, 32), seed=14)
    g = np.random.default_rng(15).standard_normal((9, 32)).astype(
        np.float32)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    mean, rstd = tln.layer_norm_stats_reference(tx)
    got = tln.layer_norm_affine_grads(tg, tx, mean, rstd, dtype)
    want = tln.layer_norm_affine_grads_plain(tg, tx, mean, rstd)
    assert got.dtype == dtype and got.shape == (2, 32)
    assert torch.equal(got, want.to(dtype))
    assert torch.allclose(want[1], tg.sum(0), atol=1e-5)


def _at_offset(n, offset, dtype=torch.bfloat16):
    """n values `offset` elements into a fresh buffer (allocations are
    at least 16-byte aligned)."""
    base = torch.zeros(n + 8, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[offset:offset + n]


def test_layout_key_keeps_each_tensors_alignment():
    # the cached layout decides a copy of x and one of the affine apart,
    # so its key holds each tensor's alignment apart: x misaligned beside
    # an aligned affine must not find the entry of an aligned x beside a
    # misaligned scale, or the launch would take a misaligned pointer
    c = 32
    x, s, b = (_at_offset(n, 0) for n in (4 * c, c, c))
    x8, s8, b8 = (_at_offset(n, 4) for n in (4 * c, c, c))
    x, x8 = x.view(4, c), x8.view(4, c)
    keys = [tln._key(*t, 1e-5) for t in ((x8, s, b), (x, s8, b),
                                         (x, s, b8), (x, s, b))]
    assert len(set(keys)) == 4
    # the same layout at other aligned pointers finds its entry again
    y, t, u = (_at_offset(n, 8) for n in (4 * c, c, c))
    assert tln._key(y.view(4, c), t, u, 1e-5) == keys[3]
