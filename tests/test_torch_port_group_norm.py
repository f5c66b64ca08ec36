"""The port's GroupNorm module (ops/group_norm.py) on the CPU: its plain
version, with and without SiLU, against the JAX package's
``models/layers.py:group_norm`` (+ ``jax.nn.silu``); the models' calls
through it, SiLU fused where the structure puts it; the kernels' launch
plan; the layout check, which refuses rather than falls back; and the
autograd Function's backward, which is the plain formula's vjp.

Tolerance 2e-5 in f32: only the order of the f32 sums differs (the JAX
package takes its statistics from shifted per-channel sums).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.models import layers as jlayers
from video_style_transfer_tpu_torch.config import CROSS, UNetConfig
from video_style_transfer_tpu_torch.config import VAEConfig
from video_style_transfer_tpu_torch.models import layers as tlayers
from video_style_transfer_tpu_torch.models import resnet as tresnet
from video_style_transfer_tpu_torch.models import unet as tunet
from video_style_transfer_tpu_torch.models import vae as tvae
from video_style_transfer_tpu_torch.ops import cuda_build
from video_style_transfer_tpu_torch.ops import group_norm as tgn


@pytest.fixture(autouse=True)
def no_library(monkeypatch):
    """CPU tensors must never reach the CUDA library."""
    def refuse():
        raise AssertionError("CPU call reached the CUDA kernel library")
    monkeypatch.setattr(cuda_build, "library", refuse)


def _inputs(shape, seed=0, shift=0.3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5 + shift).astype(np.float32)
    c = shape[-1]
    w = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, w, b


# (shape, num_groups): C/G = 4 (the VAE's 128 channels), 10 (the UNet's
# 320), 30 (960); the last two put group edges inside a bf16 vector
CASES = [((2, 4, 5, 16), 4), ((2, 3, 4, 40), 4), ((1, 6, 4, 60), 2)]


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,groups", CASES,
                         ids=[f"cpg{s[-1] // g}" for s, g in CASES])
def test_plain_matches_jax(shape, groups, eps, silu):
    x, w, b = _inputs(shape)
    want = jlayers.group_norm({"scale": jnp.asarray(w),
                               "bias": jnp.asarray(b)}, jnp.asarray(x),
                              num_groups=groups, eps=eps)
    if silu:
        want = jax.nn.silu(want)
    for got in (tgn.group_norm_reference(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b), groups, eps,
                                         silu),
                tlayers.group_norm({"weight": torch.from_numpy(w),
                                    "bias": torch.from_numpy(b)},
                                   torch.from_numpy(x), num_groups=groups,
                                   eps=eps, silu=silu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_silu_is_silu_of_the_norm(dtype):
    x, w, b = _inputs((2, 4, 4, 40), seed=1)
    p = {"weight": torch.from_numpy(w).to(dtype),
         "bias": torch.from_numpy(b).to(dtype)}
    xt = torch.from_numpy(x).to(dtype)
    fused = tlayers.group_norm(p, xt, num_groups=4, eps=1e-6, silu=True)
    apart = tlayers.silu(tlayers.group_norm(p, xt, num_groups=4, eps=1e-6))
    assert fused.dtype == dtype
    assert torch.equal(fused, apart)


# the models' shapes: (rows, positions, C, itemsize) of the video step (32
# rows; the motion modules 2 rows of 16 frames), the image step (8) and the
# fp32 decode (1 and 4 rows), and small and ragged ones
PLAN_SHAPES = [(32, 128 * 128, 320, 2), (32, 64 * 64, 1920, 2),
               (32, 32 * 32, 2560, 2), (2, 16 * 128 * 128, 320, 2),
               (2, 16 * 32 * 32, 1280, 2), (8, 32 * 32, 1280, 2),
               (8, 128 * 128, 960, 2), (1, 1024 * 1024, 128, 4),
               (4, 1024 * 1024, 128, 4), (1, 128 * 128, 512, 4),
               (1, 512 * 512, 256, 4), (3, 7, 16, 4), (5, 1, 24, 2),
               (1000, 3, 32, 2), (1, 4097, 2560, 4)]


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
@pytest.mark.parametrize("rows,positions,c,itemsize", PLAN_SHAPES)
def test_launch_plan_covers_every_position_once(rows, positions, c,
                                                itemsize, resident):
    threads, k = tgn.block_threads(c, itemsize)
    vec = 16 // itemsize
    assert threads == k * (c // vec) and threads % 32 == 0
    assert threads * vec <= tgn.STAT_FLOATS
    wave = 132 * resident
    chunks, chunk = tgn.launch_plan(rows, positions, k, wave)
    bounds = tgn.chunk_bounds(positions, chunks, chunk)
    seen = np.zeros(positions, dtype=np.int64)
    for start, end in bounds:
        assert start < end  # no empty chunk
        seen[start:end] += 1
    assert (seen == 1).all()
    # one wave where the rows allow it, whole rows otherwise
    assert rows * chunks <= max(wave, rows)


def test_layout_refuses_what_the_kernels_do_not_take():
    bf = torch.bfloat16

    def layout(x, c=None, groups=32, wdt=None):
        c = x.shape[-1] if c is None else c
        w = torch.ones(c, dtype=wdt or x.dtype)
        return tgn._layout(x, w, torch.zeros(c, dtype=w.dtype), groups,
                           1e-5, False)

    with pytest.raises(TypeError):
        layout(torch.zeros(2, 4, 4, 320, dtype=torch.float16))
    with pytest.raises(TypeError):
        layout(torch.zeros(2, 4, 4, 320), wdt=torch.int32)
    with pytest.raises(ValueError):  # C not a multiple of 8 in bf16
        layout(torch.zeros(2, 4, 4, 36, dtype=bf), groups=4)
    with pytest.raises(ValueError):  # C not a multiple of the groups
        layout(torch.zeros(2, 4, 4, 320), groups=24)
    with pytest.raises(ValueError):  # more groups than the kernel holds
        layout(torch.zeros(1, 2, 2048), groups=2048)
    with pytest.raises(ValueError):  # weight of another width
        layout(torch.zeros(2, 4, 4, 320), c=640)
    with pytest.raises(ValueError):  # wider than a block's statistics
        tgn.block_threads(8200, 2)
    # a shape the kernels take, on the CPU: the entry refuses it too,
    # since a call that reaches it is meant for the card
    with pytest.raises(ValueError, match="CUDA"):
        layout(torch.zeros(2, 4, 4, 320, dtype=bf))


def test_cpu_calls_take_the_plain_version():
    x, w, b = _inputs((2, 4, 4, 40))
    before = tgn.LAUNCHES, tgn.SILU_LAUNCHES
    got = tgn.group_norm(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), 4, eps=1e-6, silu=True)
    want = tgn.group_norm_reference(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), 4, 1e-6, True)
    assert torch.equal(got, want)
    assert (tgn.LAUNCHES, tgn.SILU_LAUNCHES) == before


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("need", [(True, False, False), (True, True, True),
                                  (False, True, True)])
def test_autograd_function_backward_is_the_plain_vjp(monkeypatch, need,
                                                     silu):
    # the Function's forward launches the kernels; here it takes the plain
    # version, so that its backward runs on the CPU against the plain
    # formula's own autograd
    monkeypatch.setattr(
        tgn, "_launch", lambda x, w, b, entry: tgn.group_norm_reference(
            x, w, b, 4, 1e-6, entry[5]))
    x, w, b = _inputs((2, 3, 4, 40), seed=2)
    cot = torch.from_numpy(_inputs((2, 3, 4, 40), seed=3)[0])
    grads = []
    for fn in ("function", "plain"):
        leaves = [torch.from_numpy(a).clone().requires_grad_(n)
                  for a, n in zip((x, w, b), need)]
        if fn == "function":
            y = tgn._GroupNorm.apply(*leaves, 4, 1e-6,
                                     (None,) * 5 + (silu,))
            assert "_GroupNorm" in type(y.grad_fn).__name__
        else:
            y = tgn.group_norm_reference(*leaves, 4, 1e-6, silu)
        grads.append(torch.autograd.grad(
            y, [t for t in leaves if t.requires_grad], cot))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def _counting(monkeypatch):
    calls = []
    inner = tgn.group_norm

    def counted(x, weight, bias, num_groups, *, eps=1e-5, silu=False):
        calls.append((tuple(x.shape), silu))
        return inner(x, weight, bias, num_groups, eps=eps, silu=silu)
    monkeypatch.setattr(tgn, "group_norm", counted)
    return calls


def test_resnet_fuses_silu_into_both_norms(monkeypatch):
    calls = _counting(monkeypatch)
    ini = tlayers.Init(0)
    p = tresnet.init_resnet_block(ini, 16, 32, temb_channels=8)
    x = torch.randn(2, 4, 4, 16)
    y = tresnet.resnet_block(p, x, torch.randn(2, 8), num_groups=4)
    assert y.shape == (2, 4, 4, 32)
    assert [s for _, s in calls] == [True, True]


def test_vae_decode_calls(monkeypatch):
    # the decoder's norms: every resnet's two and conv_norm_out with SiLU,
    # the mid-block attention's without (SDXL's decoder: 30, 29 with SiLU)
    calls = _counting(monkeypatch)
    cfg = VAEConfig.tiny()
    params = tvae.init_vae_decoder(tlayers.Init(0), cfg)
    tvae.vae_decode(params, cfg, torch.randn(1, 4, 4, cfg.latent_channels))
    resnets = len(cfg.block_out_channels) * (cfg.layers_per_block + 1) + 2
    assert len(calls) == 2 * resnets + 2
    assert sum(s for _, s in calls) == 2 * resnets + 1


def expected_unet_group_norms(cfg):
    """(calls, calls with SiLU) of GroupNorm in one UNet call of `cfg`: two
    with SiLU a resnet and conv_norm_out's; one without a transformer_2d
    and a motion module."""
    lpb = cfg.layers_per_block
    resnets = len(cfg.down_block_types) * lpb + 2 \
        + len(cfg.up_block_types) * (lpb + 1)
    transformers = 1 + sum(lpb for t in cfg.down_block_types
                           if t == CROSS) \
        + sum(lpb + 1 for t in cfg.up_block_types if t == CROSS)
    motion = 0
    if cfg.use_motion_modules:
        motion = len(cfg.down_block_types) * lpb \
            + len(cfg.up_block_types) * (lpb + 1) + int(cfg.motion_mid_block)
    silu = 2 * resnets + 1
    return silu + transformers + motion, silu


def test_unet_group_norms_a_call(monkeypatch):
    # SDXL: 46 a call, 35 with SiLU; with AnimateDiff-XL's motion modules
    # 61; the tiny UNet's calls as its config gives them
    assert expected_unet_group_norms(UNetConfig.sdxl()) == (46, 35)
    assert expected_unet_group_norms(
        UNetConfig.sdxl(use_motion_modules=True)) == (61, 35)
    calls = _counting(monkeypatch)
    cfg = UNetConfig.tiny(use_motion_modules=True)
    params = tunet.init_unet(tlayers.Init(0), cfg)
    frames = 2
    with torch.no_grad():
        tunet.unet_apply(params, cfg, torch.randn(2 * frames, 16, 16, 4),
                         torch.tensor([901.0, 901.0]),
                         (torch.randn(2, 7, 32), None, None),
                         torch.randn(2, 32),
                         torch.tensor([[16.0, 16, 0, 0, 16, 16]] * 2),
                         num_frames=frames)
    assert (len(calls), sum(s for _, s in calls)) == \
        expected_unet_group_norms(cfg)
