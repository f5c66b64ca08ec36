"""The port's LPIPS (models/lpips.py) and cli/compare_outputs.py against
the JAX package's, with seeded weights in the two source naming
conventions (torchvision ``features.*``, lpips ``lin*.model.1.weight``)
at a tiny channel plan: the distance and the converter within rtol 1e-4,
atol 1e-5 (the JAX package's own LPIPS tolerance), the compare report's
PSNR and SSIM equal and its LPIPS within the same tolerance, from a .pth
and from a .safetensors weight file."""
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.cli import compare_outputs as jcompare
from video_style_transfer_tpu.models import lpips as jlpips
from video_style_transfer_tpu_torch.cli import compare_outputs as tcompare
from video_style_transfer_tpu_torch.models import lpips as tlpips
from video_style_transfer_tpu_torch.models.layers import Init

CH = (4, 8, 8, 8, 8)  # a tiny channel plan, VGG16's convs a slice
NC = (2, 2, 3, 3, 3)
TOL = dict(rtol=1e-4, atol=1e-5)


def _rand_sd(seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    c_in = 3
    for s, idxs in enumerate(tlpips.VGG16_SLICE_CONV_IDX):
        for i in idxs:
            sd[f"features.{i}.weight"] = rng.randn(
                CH[s], c_in, 3, 3).astype(np.float32) * 0.2
            sd[f"features.{i}.bias"] = rng.randn(CH[s]).astype(
                np.float32) * 0.05
            c_in = CH[s]
        sd[f"lin{s}.model.1.weight"] = rng.uniform(
            0, 1, (1, CH[s], 1, 1)).astype(np.float32)
    return sd


def test_convert_matches_jax():
    sd = _rand_sd()
    got, want = tlpips.convert_lpips(sd), jlpips.convert_lpips(sd)
    for gs, ws in zip(got["slices"], want["slices"]):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(
                g["weight"].numpy(),
                np.asarray(w["kernel"]).transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(g["bias"].numpy(),
                                          np.asarray(w["bias"]))
    for g, w in zip(got["lins"], want["lins"]):
        np.testing.assert_array_equal(g["weight"].numpy().T,
                                      np.asarray(w["kernel"]))


def test_distance_matches_jax():
    # 40: the 2x2 pools drop a row and a column at 5 x 5
    sd = _rand_sd(1)
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape).astype(np.float32) * 0.1, -1, 1)
    want = np.asarray(jlpips.lpips_distance(
        jlpips.convert_lpips(sd), jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = tlpips.lpips_distance(tlpips.convert_lpips(sd),
                                    torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_seeded_init_shapes_and_metric_properties():
    params = tlpips.init_lpips(Init(0), channels=CH, convs_per_slice=NC)
    jparams = jlpips.convert_lpips(_rand_sd())
    for gs, ws in zip(params["slices"], jparams["slices"]):
        assert [tuple(g["weight"].shape) for g in gs] == [
            tuple(np.asarray(w["kernel"]).transpose(3, 2, 0, 1).shape)
            for w in ws]
    assert all(bool((lin["weight"] >= 0).all()) for lin in params["lins"])
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1
    y = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1
    with torch.no_grad():
        assert float(tlpips.lpips_distance(params, x, x).abs().max()) <= 1e-6
        d = tlpips.lpips_distance(params, x, y)
        assert bool((d > 0).all())
        torch.testing.assert_close(tlpips.lpips_distance(params, y, x), d,
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_compare_outputs_matches_jax(tmp_path, fmt):
    from PIL import Image

    from video_style_transfer_tpu.lora.interop import save_safetensors

    rng = np.random.RandomState(3)
    a = rng.randint(0, 255, (2, 48, 48, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-20, 20, a.shape), 0,
                255).astype(np.uint8)
    paths = []
    for name, img in (("a", a[0]), ("b", b[0])):
        paths.append(str(tmp_path / f"{name}.png"))
        Image.fromarray(img).save(paths[-1])
    w = str(tmp_path / f"lpips.{fmt}")
    if fmt == "pth":
        torch.save({k: torch.from_numpy(v) for k, v in _rand_sd().items()},
                   w)
    else:
        save_safetensors(_rand_sd(), w)
    argv = ["--ours", paths[0], "--reference", paths[1], "--lpips", w]
    want = jcompare.main(argv + ["--json_out", str(tmp_path / "j.json")])
    got = tcompare.main(argv + ["--json_out", str(tmp_path / "t.json"),
                                "--device", "cpu"])
    assert json.load(open(tmp_path / "t.json")) == got
    assert set(got) == set(want)
    for k in ("frames", "psnr_mean", "ssim_mean"):
        assert got[k] == want[k], k
    for k in ("lpips_mean", "lpips_max"):
        np.testing.assert_allclose(got[k], want[k], **TOL)
    for g, f in zip(got["per_frame"], want["per_frame"]):
        assert (g["psnr"], g["ssim"]) == (f["psnr"], f["ssim"])
        np.testing.assert_allclose(g["lpips"], f["lpips"], **TOL)
    # the plain metrics on their own, without LPIPS
    assert tcompare.psnr(a[1], a[1]) == tcompare.PSNR_MAX
    assert tcompare.ssim(a[1], b[1]) == jcompare.ssim(a[1], b[1])
