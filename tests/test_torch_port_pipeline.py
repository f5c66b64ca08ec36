"""The PyTorch port's schedulers, video pipeline and CLI.

The Euler tables are held against the independent golden fixture; the
tiny 2-step video pipeline against the JAX package's with the same
weights (converted from the JAX ``init_*`` trees) and the same noise
(drawn with ``jax.random.normal`` exactly as the JAX pipeline draws it,
then handed to the port). Latents agree to 1e-4 (f32 round-off
compounds through two full UNet calls); uint8 frames may differ by one
level where a pixel sits on a rounding boundary.
"""
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.config import VAEConfig as JVAEConfig
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu.models import vae as jvae
from video_style_transfer_tpu.pipelines import sampling as jsampling
from video_style_transfer_tpu.pipelines import video as jvideo
from video_style_transfer_tpu_torch.cli import infer_video
from video_style_transfer_tpu_torch.config import UNetConfig, VAEConfig
from video_style_transfer_tpu_torch.pipelines import sampling as tsampling
from video_style_transfer_tpu_torch.pipelines import video as tvideo
from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
from video_style_transfer_tpu_torch.schedulers.euler import euler_timetable
from video_style_transfer_tpu_torch.utils import convert

_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                       "scheduler_golden.json")


@pytest.mark.parametrize("steps", [30, 50])
def test_euler_tables_match_golden(steps):
    with open(_GOLDEN) as f:
        g = json.load(f)["euler"][str(steps)]
    table = euler_timetable(make_schedule(), steps)
    np.testing.assert_array_equal(table["timesteps"],
                                  np.float32(g["timesteps"]))
    np.testing.assert_allclose(table["sigmas"],
                               np.asarray(g["sigmas"], np.float64),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(table["init_sigma"], g["init_noise_sigma"],
                               rtol=2e-5)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_generate_video_matches_jax():
    frames, res, steps, vsf = 2, 16, 2, 2
    jucfg = JUNetConfig.tiny(use_motion_modules=True)
    jvcfg = JVAEConfig.tiny()
    ju = junet.init_unet(jax.random.PRNGKey(0), jucfg)
    jv = jax.jit(lambda k: jvae.init_vae(k, jvcfg))(jax.random.PRNGKey(1))
    emb_u, emb_c = _rand(1, (1, 7, 32)), _rand(2, (1, 7, 32))
    pool_u, pool_c = _rand(3, (1, 32)), _rand(4, (1, 32))
    ids = np.float32([[res, res, 0, 0, res, res]])

    def jcond(e, p, neg):
        e = jnp.asarray(e)
        return jsampling.Conditioning(
            ctx=(e, e, e) if neg else (e, None, None), pooled=jnp.asarray(p),
            time_ids=jnp.asarray(ids))

    def tcond(e, p, neg):
        e = torch.from_numpy(e)
        return tsampling.Conditioning(
            ctx=(e, e, e) if neg else (e, None, None),
            pooled=torch.from_numpy(p), time_ids=torch.from_numpy(ids))

    key = jax.random.PRNGKey(7)
    kw = dict(num_frames=frames, height=res, width=res, num_steps=steps,
              cfg_scale=7.5, vae_scale_factor=vsf)
    # JAX generate_video == decode_video(generate_video_latents(...));
    # its two halves give both the latents and the frames
    j_lat = jax.jit(lambda p, u, c, k: jvideo.generate_video_latents(
        p, jucfg, u, c, k, mode="base", dtype=jnp.float32, **kw))(
            ju, jcond(emb_u, pool_u, True), jcond(emb_c, pool_c, False), key)
    j_frames = jax.jit(lambda v, z: jvideo.decode_video(
        v, jvcfg, z, chunk=frames))(jv, j_lat)
    noise = jax.random.normal(key, (frames, res // vsf, res // vsf, 4),
                              jnp.float32)

    tu = convert.convert_tree(ju)
    tv = convert.convert_vae_decoder(jv)
    ucfg, vcfg = UNetConfig.tiny(use_motion_modules=True), VAEConfig.tiny()
    args = (tu, ucfg, tcond(emb_u, pool_u, True),
            tcond(emb_c, pool_c, False))
    noise_t = torch.from_numpy(np.array(noise))
    t_lat = tvideo.generate_video_latents(*args, dtype=torch.float32,
                                          noise=noise_t, **kw)
    np.testing.assert_allclose(t_lat.numpy(), np.asarray(j_lat), atol=1e-4,
                               rtol=0)
    t_frames = tvideo.generate_video(tu, ucfg, tv, vcfg, *args[2:],
                                     dtype=torch.float32, noise=noise_t,
                                     decode_chunk=frames, check_finite=True,
                                     **kw)
    assert t_frames.dtype == torch.uint8
    assert t_frames.shape == (frames, res, res, 3)
    diff = np.abs(t_frames.numpy().astype(np.int32)
                  - np.asarray(j_frames).astype(np.int32))
    assert diff.max() <= 1


def test_cli_generate_smoke_cpu():
    args = infer_video.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--prompt", "a horse",
         "--modes", "base"])
    report = {}
    outs = infer_video.generate(args, report)
    video = outs["base"]
    assert video.shape == (4, 16, 16, 3) and video.dtype == np.uint8
    assert len(report["base"]["denoise_step_s"]) == 2
    assert {"weight_init_s", "base"} <= set(report)


def test_cli_refuses_lora_modes():
    # the UnZipLoRA modes need stage-1 artifacts: without them (and
    # outside --smoke) the CLI refuses before it builds any weight
    args = infer_video.build_parser().parse_args(
        ["--device", "cpu", "--prompt", "a horse", "--modes", "both"])
    with pytest.raises(SystemExit, match="required for LoRA modes"):
        infer_video.generate(args)
