"""The port's parity runbook (cli/verify_parity.py) against the JAX
package's on a tiny synthetic diffusers-layout checkpoint:

- the header-only inventory equal to JAX's, key for key, on the clean
  checkpoint and on one with a key dropped, a weight transposed, an
  unexpected key and an ignorable buffer added;
- the whole chain on the CPU (inventory, load, generate through
  ``cli.infer``, compare through ``cli.compare_outputs``), its image
  against the JAX image pipeline in f32 on the checkpoint's weights and
  the same noise (latents to uint8: within one level, the image path's
  tolerance), the compare stage's PSNR gate passing against that image,
  exit 0; a missing reference fails the gate, exit 1.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from video_style_transfer_tpu.cli import verify_parity as jverify
from video_style_transfer_tpu_torch.cli import verify_parity as tverify
from video_style_transfer_tpu_torch.utils.safetensors_io import (
    load_numpy, save_file)

PROMPT = "a photo of a dog"
RUN = ["--config_preset", "tiny", "--prompt", PROMPT,
       "--num_inference_steps", "2", "--resolution", "16", "--seeds", "0",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return tverify.make_synthetic_checkpoint(
        str(tmp_path_factory.mktemp("ckpt") / "model"))


def _inventories(path):
    from video_style_transfer_tpu.cli.common import (
        tiny_checkpoint_configs as jtiny)
    from video_style_transfer_tpu_torch.cli.common import (
        tiny_checkpoint_configs as ttiny)
    got = tverify.stage_inventory(path, ttiny())
    want = jverify.stage_inventory(path, jtiny())
    # JSON's view of both (tuples and lists alike)
    return json.loads(json.dumps(got)), json.loads(json.dumps(want))


def test_headers_and_clean_inventory_equal_jax(ckpt):
    unet = os.path.join(ckpt, "unet", "diffusion_pytorch_model.safetensors")
    assert tverify.safetensors_header(unet) == jverify.safetensors_header(
        unet)
    assert tverify.dir_header(os.path.join(ckpt, "vae")) == \
        jverify.dir_header(os.path.join(ckpt, "vae"))
    got, want = _inventories(ckpt)
    assert got == want
    assert got["ok"] and got["unet"]["keys_on_disk"] > 0


def test_inventory_of_a_damaged_checkpoint_equals_jax(ckpt, tmp_path):
    dst = str(tmp_path / "damaged")
    shutil.copytree(ckpt, dst)
    path = os.path.join(dst, "unet", "diffusion_pytorch_model.safetensors")
    sd = load_numpy(path)
    dropped = sorted(sd)[0]
    del sd[dropped]
    flipped = next(k for k in sorted(sd) if sd[k].ndim == 2)
    sd[flipped] = np.ascontiguousarray(sd[flipped].T)
    sd["totally.unexpected.weight"] = np.zeros((3, 3), np.float32)
    sd["text_model.embeddings.position_ids"] = np.zeros((1, 77), np.float32)
    save_file(sd, path)
    got, want = _inventories(dst)
    assert got == want
    u = got["unet"]
    assert not got["ok"] and u["missing"] == [dropped]
    assert [m["key"] for m in u["shape_mismatch"]] == [flipped]
    assert u["unexpected"] == ["totally.unexpected.weight"]
    assert u["ignored_buffers"] == ["text_model.embeddings.position_ids"]
    # the runbook stops at the inventory and fails
    assert tverify.main(["--pretrained_model_name_or_path", dst,
                         "--report", str(tmp_path / "r.json")] + RUN) == 1
    assert list(json.load(open(tmp_path / "r.json"))["stages"]) == [
        "inventory"]


def _jax_image(ckpt):
    """The JAX image pipeline in f32 on the checkpoint (cli.infer's
    settings for seed 0, draw 0, mode base); returns (uint8 image, the
    noise it started from)."""
    import jax
    import jax.numpy as jnp
    from video_style_transfer_tpu.cli import common as jcommon
    from video_style_transfer_tpu.pipelines import image as jimage

    jb = jcommon.load_models(ckpt, configs=jcommon.tiny_checkpoint_configs(),
                             dtype=jnp.float32)
    cond = jcommon.make_conditioning(jb, PROMPT, height=16, width=16)
    uncond = jcommon.negative_conditioning(
        jb, jcommon.DEFAULT_NEGATIVE_PROMPT, height=16, width=16)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    lat = jimage.generate_latents(
        jb.unet, jb.unet_cfg, uncond, cond, key, height=16, width=16,
        batch=1, num_steps=2, cfg_scale=5.0, sampler="euler", mode="base",
        dtype=jnp.float32, vae_scale_factor=jb.vae_scale_factor)
    img = jimage.decode_images(jb.vae, jb.vae_cfg, lat, dtype=jnp.float32)
    shape = (1, 16 // jb.vae_scale_factor, 16 // jb.vae_scale_factor,
             jb.unet_cfg.in_channels)
    return (np.asarray(img)[0],
            np.asarray(jax.random.normal(key, shape, jnp.float32)))


def test_full_chain_matches_the_jax_image_path(ckpt, tmp_path, monkeypatch):
    from PIL import Image

    from video_style_transfer_tpu.cli import common as jcommon
    from video_style_transfer_tpu_torch.cli import common as tcommon
    from video_style_transfer_tpu_torch.pipelines import image as timage

    assert tcommon.DEFAULT_NEGATIVE_PROMPT == jcommon.DEFAULT_NEGATIVE_PROMPT
    want, noise = _jax_image(ckpt)
    ref = tmp_path / "ref"
    ref.mkdir()
    Image.fromarray(want).save(ref / "base_seed0.png")

    def jax_noise(shape, generator, device="cpu"):
        assert generator.initial_seed() == 0 and tuple(shape) == noise.shape
        return torch.from_numpy(noise.copy())
    monkeypatch.setattr(timage, "draw_noise", jax_noise)
    report = str(tmp_path / "report.json")
    out = str(tmp_path / "ours")
    rc = tverify.main(["--pretrained_model_name_or_path", ckpt,
                       "--output_dir", out, "--report", report,
                       "--reference_outputs", str(ref),
                       "--psnr_min", "40"] + RUN)
    rep = json.load(open(report))
    assert rc == 0 and rep["ok"]
    assert list(rep["stages"]) == ["inventory", "load", "generate",
                                   "compare"]
    (ours,) = rep["stages"]["generate"]["outputs"]
    got = np.asarray(Image.open(ours))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    (pair,) = rep["stages"]["compare"]["pairs"]
    assert pair["psnr_gate"] and pair["psnr_mean"] >= 40
    assert not rep["stages"]["compare"]["lpips_gate_evaluated"]
    # no reference of that name: the gate fails
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tverify.main(["--pretrained_model_name_or_path", ckpt,
                         "--output_dir", out, "--report", report,
                         "--reference_outputs", str(empty)] + RUN) == 1
    assert not json.load(open(report))["stages"]["compare"]["ok"]
    # --stop_after load reads the weights and stops
    assert tverify.main(["--pretrained_model_name_or_path", ckpt,
                         "--report", report, "--stop_after", "load"]
                        + RUN) == 0
    assert list(json.load(open(report))["stages"]) == ["inventory", "load"]
