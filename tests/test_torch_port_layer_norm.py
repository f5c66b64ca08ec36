"""K7 of the PyTorch port: the plain version of the one-pass LayerNorm
against the JAX package's ``ops.layer_norm.layer_norm`` (its Pallas
kernel in interpret mode where its gate passes the shape, its reference
formula where not) and ``_reference``, on the CPU.

Tolerances: f32 2e-5 (only the order of the f32 sums differs). bf16: both
sides keep f32 inside and round once, so they agree to 2e-5 except where
an f32 difference in the last bits crosses a bf16 rounding boundary: such
an element may differ by one output ulp (2^-7 relative), and at most one
element in a thousand may do so. Gradients 5e-5 against ``jax.grad``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

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


def test_models_keep_the_library_call(monkeypatch):
    # K7 is not wired in, as in the JAX package: the models' layer_norm
    # agrees with it but never calls it
    def refuse(*a, **kw):
        raise AssertionError("models/layers.py called the K7 module")
    monkeypatch.setattr(tln, "layer_norm", refuse)
    monkeypatch.setattr(tln, "layer_norm_fwd", refuse)
    x, s, b = map(torch.from_numpy, _inputs((5, 24), seed=8))
    got = tlayers.layer_norm({"weight": s, "bias": b}, x)
    assert (got - tln.layer_norm_reference(x, s, b)).abs().max() <= 2e-6
