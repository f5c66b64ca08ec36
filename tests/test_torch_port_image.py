"""The PyTorch port's image path and three-mode serving against the JAX
package, on the CPU in f32 at the tiny configs: the LoRA fold, the
cross-attention k/v cache with live LoRA branches, DPM-Solver++, the
image and video latents in every mode with triple prompts, the CLIs and
the watermark.

Tolerances: folded weights 2e-5 (one f32 sum of two rank-4 products);
``unet_apply`` and latents 1e-4 (f32 round-off compounds through two or
three full UNet calls); scheduler tables and steps as the golden file's
own tests (2e-5 / 5e-4).
"""
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from video_style_transfer_tpu.config import UNetConfig as JUNetConfig
from video_style_transfer_tpu.lora import surgery as jsurgery
from video_style_transfer_tpu.lora import unzip as junzip
from video_style_transfer_tpu.models import unet as junet
from video_style_transfer_tpu.pipelines import image as jimage
from video_style_transfer_tpu.pipelines import sampling as jsampling
from video_style_transfer_tpu.pipelines import video as jvideo
from video_style_transfer_tpu.schedulers import ddpm as jddpm
from video_style_transfer_tpu.schedulers import dpm as jdpm
from video_style_transfer_tpu.utils import watermark as jwatermark
from video_style_transfer_tpu_torch.cli import infer, infer_video
from video_style_transfer_tpu_torch.config import UNetConfig
from video_style_transfer_tpu_torch.lora import surgery as tsurgery
from video_style_transfer_tpu_torch.lora import unzip as tunzip
from video_style_transfer_tpu_torch.models import unet as tunet
from video_style_transfer_tpu_torch.pipelines import image as timage
from video_style_transfer_tpu_torch.pipelines import sampling as tsampling
from video_style_transfer_tpu_torch.pipelines import video as tvideo
from video_style_transfer_tpu_torch.schedulers import dpm as tdpm
from video_style_transfer_tpu_torch.schedulers.ddpm import make_schedule
from video_style_transfer_tpu_torch.training.stage2 import iter_leaves
from video_style_transfer_tpu_torch.utils import convert
from video_style_transfer_tpu_torch.utils import watermark as twatermark

_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                       "scheduler_golden.json")
MODES = ["both", "content", "style"]
RES, VSF = 16, 2


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _lora_unet(motion):
    """(JAX cfg, JAX params, JAX state, port cfg, port params, port
    state): a tiny UNet with rank-4 UnZipLoRA factors, non-trivial
    mergers everywhere and column masks active on one projection."""
    jcfg = JUNetConfig.tiny(use_motion_modules=motion)
    ju = junet.init_unet(jax.random.PRNGKey(0), jcfg)
    jp, jstate = jsurgery.insert_unziplora(ju, jax.random.PRNGKey(1), rank=4)
    rng = np.random.default_rng(2)

    def mergers(path, leaf):
        name = getattr(path[-1], "key", "")
        if isinstance(name, str) and name.startswith("merge_"):
            return jnp.asarray(1.0 + 0.5 * rng.standard_normal(leaf.shape),
                               jnp.float32)
        return leaf
    jp = jax.tree_util.tree_map_with_path(mergers, jp)
    path = ("up_blocks", 0, "attentions", 1, "transformer_blocks", "attn2",
            "to_k")
    ent = dict(jsurgery.tree_get(jstate, path))
    for b in ("content", "style"):
        ent[f"use_mask_{b}"] = jnp.ones_like(ent[f"use_mask_{b}"])
        ent[f"mask_{b}"] = jnp.asarray(rng.random(ent[f"mask_{b}"].shape)
                                       > 0.5)
    jstate = jsurgery.tree_set(jstate, path, ent)
    return (jcfg, jp, jstate, UNetConfig.tiny(use_motion_modules=motion),
            convert.convert_tree(jp), convert.convert_lora_state(jstate))


@pytest.fixture(scope="module")
def image_unet():
    return _lora_unet(motion=False)


@pytest.fixture(scope="module")
def video_unet():
    return _lora_unet(motion=True)


def _conds(triple):
    """(JAX uncond, JAX cond, port uncond, port cond) from one set of
    numpy embeddings; `triple` gives the content and style streams their
    own prompts."""
    u, e = _rand(10, (1, 7, 32)), _rand(11, (1, 7, 32))
    ec, es = _rand(12, (1, 7, 32)), _rand(13, (1, 7, 32))
    pu, pc = _rand(14, (1, 32)), _rand(15, (1, 32))
    ids = np.float32([[RES, RES, 0, 0, RES, RES]])

    def build(mod, arr):
        ctx_c = (arr(e), arr(ec), arr(es)) if triple else (arr(e), None, None)
        return (mod.Conditioning(ctx=(arr(u),) * 3, pooled=arr(pu),
                                 time_ids=arr(ids)),
                mod.Conditioning(ctx=ctx_c, pooled=arr(pc),
                                 time_ids=arr(ids)))
    return (*build(jsampling, jnp.asarray), *build(tsampling,
                                                   torch.from_numpy))


# ------------------------------------------------------------- the fold

@pytest.mark.parametrize("cross_kv", [True, False],
                         ids=["fold_cross_kv", "keep_cross_kv"])
@pytest.mark.parametrize("mode", MODES)
def test_fold_matches_jax(image_unet, mode, cross_kv):
    _, jp, jstate, _, tp, tstate = image_unet
    before = dict(iter_leaves(tp))
    want, jn = jsurgery.fold_unziplora(jp, jstate, mode=mode,
                                       fold_cross_kv=cross_kv)
    got, n = tsurgery.fold_unziplora(tp, tstate, mode=mode,
                                     fold_cross_kv=cross_kv)
    # 4 layers x 2 attentions x 4 projections, less attn2's k and v; JAX
    # counts stacks of one layer each
    assert n == jn == (32 if cross_kv else 24)
    want = dict(iter_leaves(convert.convert_tree(want)))
    got = dict(iter_leaves(got))
    assert set(got) == set(want)
    assert any("lora" in path for path in got) == (not cross_kv)
    changed = 0
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[path].numpy(), atol=2e-5,
                                   rtol=0, err_msg=str(path))
        changed += path in before and t is not before[path]
    assert changed == n   # exactly the folded weights are new tensors
    # the input tree is as it was: same leaves, same tensors
    after = dict(iter_leaves(tp))
    assert set(after) == set(before)
    assert all(after[k] is before[k] for k in before)


def test_lora_helpers_match_jax(image_unet):
    _, jp, jstate, _, tp, tstate = image_unet
    jpath = ("up_blocks", 0, "attentions", 1, "transformer_blocks", "attn2",
             "to_k")
    tpath = jpath[:5] + (0,) + jpath[5:]
    jl = jax.tree.map(lambda a: a[0], jsurgery.tree_get(jp, jpath + ("lora",)))
    jst = jax.tree.map(lambda a: a[0], jsurgery.tree_get(jstate, jpath))
    tl = tsurgery.tree_get(tp, tpath + ("lora",))
    tst = tsurgery.tree_get(tstate, tpath)
    for branch in ("content", "style"):
        for got, want in zip(tunzip.export_weights(tl, tst, branch),
                             junzip.export_weights(jl, jst, branch)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for merge in (False, True):
            np.testing.assert_allclose(
                tunzip.composed_delta(tl, branch, merge).numpy(),
                np.asarray(junzip.composed_delta(jl, branch, merge)),
                atol=2e-6)
    # block separation: one branch switched off at one projection
    assert tpath in set(tsurgery.iter_lora_state_paths(tstate))
    off = tsurgery.set_branch_gates(tstate, {tpath}, "content")
    want = convert.convert_lora_state(
        jsurgery.set_branch_gates(jstate, {jpath}, "content"))
    got, want = dict(iter_leaves(off)), dict(iter_leaves(want))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert bool(tsurgery.tree_get(tstate, tpath)["on_content"])   # input kept
    np.testing.assert_allclose(
        tunzip.folded_delta(tl, tsurgery.tree_get(off, tpath)).numpy(),
        np.asarray(junzip.folded_delta(
            jl, {**jst, "on_content": jnp.asarray(False)})), atol=2e-6)


def _unet_inputs(frames=1):
    return (torch.from_numpy(_rand(20, (2 * frames, 8, 8, 4))),
            torch.tensor([10.0, 500.0]),
            torch.from_numpy(_rand(21, (2, 32))),
            torch.tensor([[RES, RES, 0, 0, RES, RES]] * 2,
                         dtype=torch.float32))


@pytest.mark.parametrize("mode", MODES)
def test_folded_unet_matches_dynamic(image_unet, mode):
    _, _, _, tcfg, tp, tstate = image_unet
    x, t, pooled, ids = _unet_inputs()
    ctx = (torch.from_numpy(_rand(22, (2, 7, 32))), None, None)
    folded, _ = tsurgery.fold_unziplora(tp, tstate, mode=mode,
                                        fold_cross_kv=True)
    with torch.no_grad():
        want = tunet.unet_apply(tp, tcfg, x, t, ctx, pooled, ids, mode=mode,
                                state=tstate)
        got = tunet.unet_apply(folded, tcfg, x, t, ctx, pooled, ids,
                               mode=mode, state=tstate)
        base = tunet.unet_apply(tp, tcfg, x, t, ctx, pooled, ids,
                                mode="base")
    assert (got - want).abs().max() <= 1e-4
    assert (base - want).abs().max() > 1e-2   # the LoRA is not a no-op


# ---------------------- the cross-attention k/v cache with live LoRA

@pytest.mark.parametrize("mode", MODES)
def test_cross_kv_cache_keeps_lora_branches(image_unet, mode):
    jcfg, jp, jstate, tcfg, tp, tstate = image_unet
    x, t, pooled, ids = _unet_inputs()
    ctx = tuple(_rand(30 + i, (2, 7, 32)) for i in range(3))
    want = junet.unet_apply(
        jp, jcfg, jnp.asarray(x.numpy()), jnp.asarray(t.numpy()),
        tuple(map(jnp.asarray, ctx)), jnp.asarray(pooled.numpy()),
        jnp.asarray(ids.numpy()), mode=mode, state=jstate)
    tctx = tuple(map(torch.from_numpy, ctx))
    # the image CLI's tree: everything folded but the cross-attention k/v
    folded, _ = tsurgery.fold_unziplora(tp, tstate, mode=mode)
    with torch.no_grad():
        for params in (tp, folded):
            kv = tunet.precompute_cross_kv(params, tcfg, tctx, mode=mode,
                                           state=tstate)
            cached = tunet.unet_apply(params, tcfg, x, t, tctx, pooled, ids,
                                      mode=mode, state=tstate, cross_kv=kv)
            plain = tunet.unet_apply(params, tcfg, x, t, tctx, pooled, ids,
                                     mode=mode, state=tstate)
            assert (cached - plain).abs().max() <= 1e-4
            np.testing.assert_allclose(cached.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
        # a cache taken in "base" mode drops the deltas, and it shows
        kv = tunet.precompute_cross_kv(tp, tcfg, tctx)
        dropped = tunet.unet_apply(tp, tcfg, x, t, tctx, pooled, ids,
                                   mode=mode, state=tstate, cross_kv=kv)
    assert (dropped - plain).abs().max() > 1e-3


# ----------------------------------------------------------------- DPM

def _golden():
    with open(_GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("steps", [30, 50])
def test_dpm_tables_match_golden_and_jax(steps):
    g = _golden()["dpm"][str(steps)]
    table = tdpm.dpm_timetable(make_schedule(), steps)
    np.testing.assert_array_equal(table["timesteps"],
                                  np.float32(g["timesteps"]))
    kar = np.asarray(g["sigmas"], np.float64)
    np.testing.assert_allclose(table["sigma"], kar / np.sqrt(kar ** 2 + 1),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(table["alpha"], 1 / np.sqrt(kar ** 2 + 1),
                               rtol=2e-5)
    for kw in ({}, {"final_sigma": "sigma_min"},
               {"timestep_spacing": "linspace"}):
        want = jdpm.dpm_timetable(jddpm.make_schedule(), steps, **kw)
        got = tdpm.dpm_timetable(make_schedule(), steps, **kw)
        for key in ("timesteps", "alpha", "sigma", "lambda"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       rtol=1e-6, atol=0, err_msg=key)


@pytest.mark.parametrize("steps", [30, 50])
def test_dpm_trajectory_matches_golden_and_jax(steps):
    g = _golden()
    dim = int(g["dim"])
    want = np.asarray(g["dpm"][str(steps)]["trajectory"])
    table = tdpm.dpm_timetable(make_schedule(), steps)
    jtable = jdpm.dpm_timetable(jddpm.make_schedule(), steps)
    base = np.random.RandomState(123).randn(steps, dim).astype(np.float32)
    x0_ = np.random.RandomState(7).randn(dim).astype(np.float32)
    x, jx = torch.from_numpy(x0_), jnp.asarray(x0_)
    carry = tdpm.dpm_init_carry(x.shape)
    jcarry = jdpm.dpm_init_carry(jx.shape)
    for i in range(steps):
        # the golden file's toy denoiser
        eps = torch.from_numpy(base[i]) + 0.1 * torch.tanh(x.mean())
        x0 = tdpm.to_x0(x, eps, table["alpha"][i], table["sigma"][i])
        x, carry = tdpm.dpm_step(x, x0, carry, i, table)
        jeps = jnp.asarray(base[i]) + 0.1 * jnp.tanh(jx.mean())
        jx0 = jdpm.to_x0(jx, jeps, jtable["alpha"][i], jtable["sigma"][i])
        jx, jcarry = jdpm.dpm_step(jx, jx0, jcarry, i, jtable)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-5,
                                   atol=2e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(x.numpy(), want[i + 1], rtol=5e-4,
                                   atol=5e-4, err_msg=f"step {i}")


def test_to_x0_prediction_types():
    x, out = _rand(40, (2, 3)), _rand(41, (2, 3))
    for kind in ("epsilon", "v_prediction", "sample"):
        want = jdpm.to_x0(jnp.asarray(x), jnp.asarray(out), 0.8, 0.6,
                          prediction_type=kind)
        got = tdpm.to_x0(torch.from_numpy(x), torch.from_numpy(out), 0.8,
                         0.6, prediction_type=kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ------------------------------------------------ latents against JAX

CASES = [("euler", "both", True, 0.0), ("euler", "content", True, 0.0),
         ("euler", "style", True, 0.0), ("euler", "base", False, 0.0),
         ("dpm", "both", True, 0.7), ("dpm", "style", False, 0.0)]


@pytest.mark.parametrize("sampler,mode,triple,rescale", CASES,
                         ids=[f"{s}-{m}-{'triple' if t else 'shared'}-{r}"
                              for s, m, t, r in CASES])
def test_image_latents_match_jax(image_unet, sampler, mode, triple, rescale):
    jcfg, jp, jstate, tcfg, tp, tstate = image_unet
    ju, jc, tu, tc = _conds(triple)
    key = jax.random.PRNGKey(7)
    kw = dict(height=RES, width=RES, batch=1, num_steps=3, cfg_scale=5.0,
              guidance_rescale=rescale, sampler=sampler, mode=mode,
              vae_scale_factor=VSF)
    want = jax.jit(lambda p, s, u, c, k: jimage.generate_latents(
        p, jcfg, u, c, k, state=s, dtype=jnp.float32, **kw))(
            jp, jstate, ju, jc, key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (1, RES // VSF, RES // VSF, 4), jnp.float32)))
    # the CLI's tree: folded wherever the streams coincide
    folded, _ = tsurgery.fold_unziplora(tp, tstate, mode=mode,
                                        fold_cross_kv=not triple) \
        if mode != "base" else (tp, 0)
    with torch.no_grad():
        for params in (tp, folded):
            got = timage.generate_latents(
                params, tcfg, tu, tc, state=tstate, dtype=torch.float32,
                noise=noise, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["both", "content", "style", "base"])
def test_video_latents_match_jax(video_unet, mode):
    jcfg, jp, jstate, tcfg, tp, tstate = video_unet
    ju, jc, tu, tc = _conds(False)
    key = jax.random.PRNGKey(3)
    kw = dict(num_frames=2, height=RES, width=RES, num_steps=2,
              cfg_scale=7.5, mode=mode, vae_scale_factor=VSF)
    want = jax.jit(lambda p, s, u, c, k: jvideo.generate_video_latents(
        p, jcfg, u, c, k, state=s, dtype=jnp.float32, **kw))(
            jp, jstate, ju, jc, key)
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (2, RES // VSF, RES // VSF, 4), jnp.float32)))
    # as the video CLI serves it: every LoRA folded, none left to run
    params = tp if mode == "base" else tsurgery.fold_unziplora(
        tp, tstate, mode=mode, fold_cross_kv=True)[0]
    with torch.no_grad():
        got = tvideo.generate_video_latents(
            params, tcfg, tu, tc, state=tstate, dtype=torch.float32,
            noise=noise, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_rescale_and_tile_match_jax():
    a, b = _rand(50, (2, 4, 4, 4)), _rand(51, (2, 4, 4, 4), 3.0)
    want = jsampling.rescale_noise_cfg(jnp.asarray(b), jnp.asarray(a), 0.7)
    got = tsampling.rescale_noise_cfg(torch.from_numpy(b),
                                      torch.from_numpy(a), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    _, jc, _, tc = _conds(False)
    jt, tt = jsampling.tile_conditioning(jc, 3), \
        tsampling.tile_conditioning(tc, 3)
    assert tt.ctx[1] is None and tt.ctx[2] is None
    for got, want in ((tt.ctx[0], jt.ctx[0]), (tt.pooled, jt.pooled),
                      (tt.time_ids, jt.time_ids)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_row_generators_equal_batch_one_draws(image_unet):
    _, _, _, tcfg, tp, _ = image_unet
    shape = (3, 8, 8, 4)
    rows = timage.draw_noise(
        shape, [torch.Generator().manual_seed(s) for s in (5, 6, 7)])
    for i, s in enumerate((5, 6, 7)):
        one = timage.draw_noise((1,) + shape[1:],
                                torch.Generator().manual_seed(s))
        assert torch.equal(rows[i:i + 1], one)
    with pytest.raises(ValueError, match="generators"):
        timage.draw_noise(shape, [torch.Generator()])
    # and through the pipeline: row i of a batch is the batch-1 sample
    _, _, tu, tc = _conds(True)
    kw = dict(height=RES, width=RES, num_steps=2, dtype=torch.float32,
              vae_scale_factor=VSF, mode="base")
    with torch.no_grad():
        both = timage.generate_latents(
            tp, tcfg, tsampling.tile_conditioning(tu, 2),
            tsampling.tile_conditioning(tc, 2), batch=2,
            generator=[torch.Generator().manual_seed(s) for s in (5, 6)],
            **kw)
        one = timage.generate_latents(
            tp, tcfg, tu, tc, batch=1,
            generator=torch.Generator().manual_seed(6), **kw)
    assert (both[1:] - one).abs().max() <= 1e-5


def test_generate_images_is_latents_then_decode(image_unet):
    from video_style_transfer_tpu_torch.config import VAEConfig
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.vae import init_vae_decoder
    _, _, _, tcfg, tp, tstate = image_unet
    _, _, tu, tc = _conds(True)
    vcfg = VAEConfig.tiny()
    vae = init_vae_decoder(Init(1), vcfg)
    kw = dict(height=RES, width=RES, num_steps=2, sampler="dpm", mode="both",
              state=tstate, dtype=torch.float32, vae_scale_factor=VSF,
              noise=torch.from_numpy(_rand(60, (1, 8, 8, 4))))
    with torch.no_grad():
        imgs = timage.generate_images(tp, tcfg, vae, vcfg, tu, tc,
                                      check_finite=True, **kw)
        lat = timage.generate_latents(tp, tcfg, tu, tc, **kw)
        assert torch.equal(imgs, timage.decode_images(vae, vcfg, lat))
        fast = timage.decode_images(vae, vcfg, lat, dtype=torch.bfloat16)
    assert imgs.shape == (1, RES, RES, 3) and imgs.dtype == torch.uint8
    # the bf16 decode stays within a few levels of the fp32 one
    assert (fast.int() - imgs.int()).abs().max() <= 8
    assert vae["post_quant_conv"]["weight"].dtype == torch.float32


# ----------------------------------------------------------------- CLIs

@pytest.mark.parametrize("mode", ["both", "content", "style", "base"])
def test_image_cli_smoke_cpu(mode):
    argv = ["--smoke", "--device", "cpu", "--prompt", "a dog in watercolor",
            "--prompt_content", "a dog", "--prompt_style", "watercolor",
            "--mode", mode, "--seeds", "0", "1", "--sampler", "dpm"]
    report = {}
    outs = infer.generate(infer.build_parser().parse_args(argv), report)
    assert set(outs) == {f"{mode}_seed0", f"{mode}_seed1"}
    for img in outs.values():
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert not np.array_equal(*outs.values())
    # 4 layers x (attn1 q, k, v, out + attn2 q, out)
    assert report["n_folded"] == (0 if mode == "base" else 24)
    assert len(report["images"][f"{mode}_seed0"]["denoise_step_s"]) == 2
    again = infer.generate(infer.build_parser().parse_args(argv))
    assert all(np.array_equal(again[k], v) for k, v in outs.items())


def test_image_cli_writes_pngs_and_watermarks(tmp_path):
    paths = infer.main(["--smoke", "--device", "cpu", "--prompt", "a dog",
                        "--mode", "base", "--seeds", "3", "--num", "2",
                        "--watermark", "--output_dir", str(tmp_path)])
    assert [os.path.basename(p) for p in paths] == ["base_seed3_0.png",
                                                    "base_seed3_1.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_video_cli_smoke_cpu_every_mode():
    modes = ["base", "both", "content", "style"]
    report = {}
    outs = infer_video.generate(infer_video.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--prompt", "a horse",
         "--content_prompt", "a horse", "--style_prompt", "in snow",
         "--modes", *modes]), report)
    assert list(outs) == modes
    for mode in modes:
        assert outs[mode].shape == (4, 16, 16, 3)
        assert report[mode]["n_folded"] == (0 if mode == "base" else 32)
    for a in range(4):
        for b in range(a + 1, 4):
            assert not np.array_equal(outs[modes[a]], outs[modes[b]])


@pytest.mark.parametrize("cli,flag,value", [
    (infer, "--tp", "2"), (infer, "--dp", "2"),
    (infer, "--num_processes", "2"),
    (infer_video, "--frame_parallel", "2"),
    (infer_video, "--coordinator_address", "localhost:1234")])
def test_cli_refuses_multi_gpu_flags(cli, flag, value):
    # the multi-GPU flags refuse a world that cannot hold them
    match = {"--tp": "needs 2 processes", "--dp": "needs 2 processes",
             "--frame_parallel": "needs 2 processes",
             "--num_processes": "need --coordinator_address",
             "--coordinator_address": "needs --num_processes"}[flag]
    args = cli.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--prompt", "a horse", flag, value])
    with pytest.raises(SystemExit, match=match):
        cli.generate(args)


def test_image_cli_refuses_lora_mode_without_artifacts():
    args = infer.build_parser().parse_args(
        ["--device", "cpu", "--prompt", "a dog", "--mode", "both"])
    with pytest.raises(SystemExit, match="required for LoRA modes"):
        infer.generate(args)


# ------------------------------------------------------------ watermark

def test_watermark_matches_jax():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 256, 320, 3), dtype=np.uint8)
    want = jwatermark.apply_watermark(imgs)
    got = twatermark.apply_watermark(imgs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twatermark.WATERMARK_BITS,
                                  jwatermark.WATERMARK_BITS)
    smooth = np.full((256, 256, 3), 128, np.uint8)
    stamped = twatermark.apply_watermark(smooth)
    np.testing.assert_array_equal(twatermark.decode_watermark(stamped),
                                  jwatermark.decode_watermark(stamped))
    assert twatermark.has_watermark(stamped)
    assert not twatermark.has_watermark(smooth)
    small = imgs[0, :64, :64]
    assert twatermark.apply_watermark(small) is small or np.array_equal(
        twatermark.apply_watermark(small), small)
