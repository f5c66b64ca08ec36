"""The PyTorch port's models against the JAX package at tiny configs.

Weights come from the JAX ``init_*`` functions and go through the port's
utils/convert.py; inputs are numpy draws from a seed; everything is f32
on the CPU (the JAX side reaches its Pallas kernels in interpret mode).
Single modules agree to 2e-5. Whole models are held to 1e-4: the order
of the f32 sums differs between the two frameworks (matmul blocking,
conv algorithms, GroupNorm's two-pass vs shifted statistics) and that
round-off compounds over the depth.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.config import CLIPConfig as JCLIPConfig
from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.config import VAEConfig as JVAEConfig
from video_style_transfer_tpu.models import clip as jclip
from video_style_transfer_tpu.models import motion as jmotion
from video_style_transfer_tpu.models import resnet as jresnet
from video_style_transfer_tpu.models import transformer as jtf
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu.models import vae as jvae
from video_style_transfer_tpu_torch.config import (
    CLIPConfig, UNetConfig, VAEConfig)
from video_style_transfer_tpu_torch.models import clip as tclip
from video_style_transfer_tpu_torch.models import motion as tmotion
from video_style_transfer_tpu_torch.models import resnet as tresnet
from video_style_transfer_tpu_torch.models import transformer as ttf
from video_style_transfer_tpu_torch.models import unet as tunet
from video_style_transfer_tpu_torch.models import vae as tvae
from video_style_transfer_tpu_torch.utils import convert

MODULE_TOL = 2e-5
MODEL_TOL = 1e-4
FRAMES = 2
ROWS = 2 * FRAMES  # CFG pair x frames


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _jit(fn, *args, **static):
    """Run a JAX function jitted (far faster than eager op-by-op dispatch
    once it holds interpret-mode Pallas kernels)."""
    return jax.jit(functools.partial(fn, **static))(*args)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


@pytest.fixture(scope="module")
def unet_params():
    cfg = JUNetConfig.tiny(use_motion_modules=True)
    jp = junet.init_unet(jax.random.PRNGKey(0), cfg)
    return jp, convert.convert_tree(jp)


def test_configs_match_jax():
    for jc, tc in ((JUNetConfig.tiny(use_motion_modules=True),
                    UNetConfig.tiny(use_motion_modules=True)),
                   (JUNetConfig.sdxl(), UNetConfig.sdxl()),
                   (JVAEConfig.sdxl(), VAEConfig.sdxl()),
                   (JCLIPConfig.sdxl_big_g(), CLIPConfig.sdxl_big_g())):
        assert jc.__dict__ == tc.__dict__


def test_transformer_2d(unet_params):
    jp, tp = unet_params
    jblk, tblk = (p["down_blocks"][1]["attentions"][0] for p in (jp, tp))
    x = _rand(1, (ROWS, 8, 8, 64))
    ctx = _rand(2, (ROWS, 7, 32))
    want = _jit(jtf.transformer_2d, jblk, jnp.asarray(x),
                (jnp.asarray(ctx), None, None), heads=4, norm_num_groups=8)
    got = ttf.transformer_2d(tblk, _t(x), (_t(ctx), None, None), heads=4,
                             norm_num_groups=8)
    _close(got, want, MODULE_TOL)


def test_resnet_block(unet_params):
    jp, tp = unet_params
    jr, tr = (p["down_blocks"][1]["resnets"][0] for p in (jp, tp))
    x = _rand(3, (ROWS, 8, 8, 32))
    temb = _rand(4, (ROWS, 128))
    want = _jit(jresnet.resnet_block, jr, jnp.asarray(x), jnp.asarray(temb),
                num_groups=8)
    got = tresnet.resnet_block(tr, _t(x), _t(temb), num_groups=8)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("level,channels", [(0, 32), (1, 64)])
def test_motion_module(unet_params, level, channels):
    # 8 heads: d = 4 at level 0 (plain route on both sides), d = 8 at
    # level 1 (the JAX temporal-attention kernel)
    jp, tp = unet_params
    jm, tm = (p["down_blocks"][level]["motion_modules"][0] for p in (jp, tp))
    x = _rand(5 + level, (ROWS, 8, 8, channels))
    want = _jit(jmotion.motion_module, jm, jnp.asarray(x),
                num_frames=FRAMES, heads=8, norm_num_groups=8)
    got = tmotion.motion_module(tm, _t(x), num_frames=FRAMES, heads=8,
                                norm_num_groups=8)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("precompute", [False, True])
def test_unet_apply_with_motion(unet_params, precompute):
    jp, tp = unet_params
    jcfg = JUNetConfig.tiny(use_motion_modules=True)
    tcfg = UNetConfig.tiny(use_motion_modules=True)
    sample = _rand(7, (ROWS, 16, 16, 4))
    ctx = _rand(8, (2, 7, 32))
    pooled = _rand(9, (2, 32))
    time_ids = np.tile(np.float32([[16, 16, 0, 0, 16, 16]]), (2, 1))
    ts = np.float32([901.0, 901.0])
    jkv = tkv = None
    if precompute:
        jkv = junet.precompute_cross_kv(jp, jcfg, (jnp.asarray(ctx), None,
                                                   None), num_frames=FRAMES)
        tkv = tunet.precompute_cross_kv(tp, tcfg, (_t(ctx), None, None),
                                        num_frames=FRAMES)
    want = _jit(lambda *a: junet.unet_apply(
        a[0], jcfg, *a[1:], mode="base", num_frames=FRAMES, cross_kv=jkv),
        jp, jnp.asarray(sample), jnp.asarray(ts),
        (jnp.asarray(ctx), None, None), jnp.asarray(pooled),
        jnp.asarray(time_ids))
    got = tunet.unet_apply(tp, tcfg, _t(sample), _t(ts),
                           (_t(ctx), None, None), _t(pooled), _t(time_ids),
                           num_frames=FRAMES, cross_kv=tkv)
    assert got.shape == sample.shape
    _close(got, want, MODEL_TOL)


def test_clip_apply():
    jcfg, tcfg = JCLIPConfig.tiny(), CLIPConfig.tiny()
    jp = _jit(lambda k: jclip.init_clip(k, jcfg), jax.random.PRNGKey(1))
    tp = convert.convert_tree(jp)
    ids = np.random.default_rng(10).integers(0, 998, (2, 77))
    ids[0, 5:] = 999
    ids[1, 30:] = 999
    want = _jit(lambda p, i: jclip.clip_apply(p, jcfg, i, eos_token_id=999),
                jp, jnp.asarray(ids))
    got = tclip.clip_apply(tp, tcfg, torch.from_numpy(ids),
                           eos_token_id=999)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)


def test_vae_decode():
    jcfg, tcfg = JVAEConfig.tiny(), VAEConfig.tiny()
    jp = _jit(lambda k: jvae.init_vae(k, jcfg), jax.random.PRNGKey(2))
    tp = convert.convert_vae_decoder(jp)
    z = _rand(11, (2, 8, 8, 4))
    want = _jit(lambda p, x: jvae.vae_decode(p, jcfg, x), jp, jnp.asarray(z))
    got = tvae.vae_decode(tp, tcfg, _t(z))
    assert got.shape == (2, 16, 16, 3)
    _close(got, want, MODEL_TOL)
