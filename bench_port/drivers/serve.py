"""The serving generator: closed-loop requests through the program's
video or image pipeline, as a user of its CLIs meets them.

A traffic file of kind "serve" gives the pipeline ("video": one request
is one clip of ``frames`` frames, in the calls and order of
``cli/infer_video.generate``'s per-mode loop; "image": one request is one
prompt at ``len(noise_seeds)`` rows, one generator a row, as
``cli/infer.py`` serves its fixed seeds), the sizes, steps, guidance,
mode, prompts and the decode. The run's seed draws the weights, each
request's prompt and each row's noise; every seed gives the same sizes.

The program is observed, never changed: ``pipelines/sampling.py``'s
``euler_step`` and ``pipelines/image.py``'s ``vae_decode`` are wrapped so
that each step's state, guided eps and result, and each decoded
frame's pixels, are kept for the reference after the window.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port.lib import trace as tr
from bench_port.lib import weights
from bench_port.reference import params as refp

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mix(*parts) -> int:
    """A 63-bit seed from whole numbers of any size."""
    return int(np.random.SeedSequence([int(p) % 2 ** 64 for p in parts])
               .generate_state(1, np.uint64)[0] >> 1)


def build_weights(cfg: dict, seed: int, device):
    """The benchmark's weights, from `seed`, on `device`: UNet and CLIPs
    in their serving dtype, the VAE decoder in float32, the UnZipLoRA
    factors in float32 on every spatial attention projection."""
    dt = cfg["dtypes"]
    low = weights.Recorder(_DTYPES[dt["unet"]])
    f32 = weights.Recorder(torch.float32)
    clip_rec = weights.Recorder(_DTYPES[dt["clip"]])
    trees = {"unet": refp.unet(low, cfg["unet"]),
             "clip_l": refp.clip(clip_rec, cfg["clip_l"]),
             "clip_g": refp.clip(clip_rec, cfg["clip_g"]),
             "vae": refp.vae_decoder(f32, cfg["vae"])}
    lora = cfg["unziplora"]
    refp.add_unziplora(f32, trees["unet"], lora["rank"],
                       lora["merge_spread"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for rec in (low, clip_rec, f32):
        trees = weights.materialize(trees, rec, gen, device)
    trees["state"] = refp.unziplora_state(trees["unet"], device)
    return trees


class Recorder:
    """What the timed path produced, per request: each Euler call's
    (sample, eps, sigma, sigma_next, result) and each decode's (latents,
    pixels)."""

    def __init__(self):
        self.requests = []
        self.on = False

    def begin(self):
        self.requests.append({"steps": [], "decodes": []})

    def euler(self, fn):
        fn = getattr(fn, "__wrapped__", fn)

        def euler_step(sample, model_output, sigma, sigma_next):
            out = fn(sample, model_output, sigma, sigma_next)
            if self.on:
                self.requests[-1]["steps"].append(
                    (sample, model_output, float(sigma), float(sigma_next),
                     out))
            return out
        euler_step.__wrapped__ = fn
        return euler_step

    def decode(self, fn):
        fn = getattr(fn, "__wrapped__", fn)

        def vae_decode(params, cfg, z):
            out = fn(params, cfg, z)
            if self.on:
                self.requests[-1]["decodes"].append((z, out))
            return out
        vae_decode.__wrapped__ = fn
        return vae_decode


class Driver:
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int,
                 device, trace: bool):
        self.cfg, self.traffic, self.spec = cfg, traffic, spec
        self.seed, self.device, self.trace = seed, torch.device(device), trace
        self.video = traffic["pipeline"] == "video"
        self.rec = Recorder()
        self.ranges = tr.Ranges(markers=False)
        self.entries = tr.EntryLog()
        self.step_ms, self.decode_ms, self.prompts = [], [], []
        self.noise_seeds = []
        self.params = None

    # ---- set-up ----------------------------------------------------------

    def setup(self):
        from video_style_transfer_tpu_torch.cli import common
        from video_style_transfer_tpu_torch.config import (
            CLIPConfig, UNetConfig, VAEConfig)
        from video_style_transfer_tpu_torch.lora.surgery import (
            fold_unziplora)
        from video_style_transfer_tpu_torch.pipelines import image, sampling

        def tup(d):
            return {k: tuple(v) if isinstance(v, list) else v
                    for k, v in d.items()}

        c, t = self.cfg, self.traffic
        self.w = build_weights(c, self.seed, self.device)
        self.bundle = common.ModelBundle(
            unet=self.w["unet"], unet_cfg=UNetConfig(**tup(c["unet"])),
            vae=self.w["vae"], vae_cfg=VAEConfig(**tup(c["vae"])),
            clip_l=self.w["clip_l"], clip_l_cfg=CLIPConfig(**c["clip_l"]),
            clip_g=self.w["clip_g"], clip_g_cfg=CLIPConfig(**c["clip_g"]),
            device=self.device,
            vae_scale_factor=2 ** (len(c["vae"]["block_out_channels"]) - 1))
        sampling.euler_step = self.rec.euler(sampling.euler_step)
        image.vae_decode = self.rec.decode(image.vae_decode)
        if self.trace:
            tr.install_entry_wrappers(self.entries)
        self.dtype = _DTYPES[c["dtypes"]["unet"]]
        self.decode_dtype = _DTYPES[t["decode_dtype"]]
        with torch.inference_mode():
            self.uncond = common.negative_conditioning(
                self.bundle, t["negative_prompt"], height=t["height"],
                width=t["width"])
            if not t["fold_per_request"]:
                self.params, _ = fold_unziplora(
                    self.w["unet"], self.w["state"], mode=t["mode"],
                    fold_cross_kv=t["fold_cross_kv"])
            # every shape of a request, at one step
            self._request(-1, steps=1)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- a request ---------------------------------------------------------

    def prompt(self, i: int) -> dict:
        ps = self.traffic["prompts"]
        return ps[mix(self.seed, i, 1) % len(ps)]

    def row_seeds(self, i: int):
        return [mix(self.seed, i, s) for s in self.traffic["noise_seeds"]]

    def request(self, i: int):
        self.rec.on = True
        self.rec.begin()
        try:
            with torch.inference_mode():
                self._request(i, steps=self.traffic["steps"])
        finally:
            self.rec.on = False

    def _request(self, i: int, steps: int):
        from video_style_transfer_tpu_torch.cli import common
        from video_style_transfer_tpu_torch.lora.surgery import (
            fold_unziplora)
        from video_style_transfer_tpu_torch.pipelines.image import (
            decode_images, generate_latents)
        from video_style_transfer_tpu_torch.pipelines.sampling import (
            tile_conditioning)
        from video_style_transfer_tpu_torch.pipelines.video import (
            decode_video, generate_video_latents)

        t, rg, cuda = self.traffic, self.ranges, self.device.type == "cuda"
        p = self.prompt(i)
        seeds = self.row_seeds(i)
        if i >= 0:
            self.prompts.append(p)
            self.noise_seeds.append(seeds)
        with rg("request"):
            with rg("encode"):
                cond = common.make_conditioning(
                    self.bundle, p["prompt"], p.get("content"),
                    p.get("style"), height=t["height"], width=t["width"])
            params = self.params if not t["fold_per_request"] else None
            if params is None:
                with rg("fold"):
                    params, _ = fold_unziplora(
                        self.w["unet"], self.w["state"], mode=t["mode"],
                        fold_cross_kv=t["fold_cross_kv"])
            events = []

            def on_step(k):
                rg.close()
                if cuda:
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                if k + 1 < steps:
                    rg.open("step")

            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            rg.open("step")
            common_kw = dict(num_steps=steps, mode=t["mode"],
                             state=self.w["state"], dtype=self.dtype,
                             vae_scale_factor=self.bundle.vae_scale_factor,
                             device=self.device, on_step=on_step)
            if self.video:
                latents = generate_video_latents(
                    params, self.bundle.unet_cfg, self.uncond, cond,
                    num_frames=t["frames"], height=t["height"],
                    width=t["width"], cfg_scale=t["guidance_scale"],
                    generator=common.seeded_generator(seeds[0]), **common_kw)
            else:
                rows = len(seeds)
                latents = generate_latents(
                    params, self.bundle.unet_cfg,
                    tile_conditioning(self.uncond, rows),
                    tile_conditioning(cond, rows), height=t["height"],
                    width=t["width"], batch=rows,
                    cfg_scale=t["guidance_scale"], sampler="euler",
                    generator=[common.seeded_generator(s) for s in seeds],
                    **common_kw)
            del params
            with rg("decode"):
                if cuda:
                    d0 = torch.cuda.Event(enable_timing=True)
                    d0.record()
                if self.video:
                    out = decode_video(self.bundle.vae, self.bundle.vae_cfg,
                                       latents, chunk=t["decode_chunk"],
                                       dtype=self.decode_dtype,
                                       check_finite=True)
                else:
                    out = decode_images(self.bundle.vae, self.bundle.vae_cfg,
                                        latents, dtype=self.decode_dtype,
                                        check_finite=True)
                if cuda:
                    d1 = torch.cuda.Event(enable_timing=True)
                    d1.record()
                out = out.cpu()
        if i >= 0:
            self.rec.requests[-1]["frames"] = out
            if cuda:
                self.step_ms.append(events[0].elapsed_time(events[-1])
                                    / steps)
                self.decode_ms.append(d0.elapsed_time(d1) / out.shape[0])

    # ---- what the benchmark reads ------------------------------------------

    def release(self):
        """Drop the program's own state before the reference runs."""
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def request_model_flops(self):
        """(bf16 flops, fp32 flops) of one request, counted on ``meta``
        tensors by the reference at this traffic's shapes."""
        from bench_port.lib import flops
        return flops.serve_request(self.cfg, self.traffic)

    # ---- correctness ------------------------------------------------------

    def check(self, fp8: bool = False, tf32: bool = False):
        """Readings of the request drawn from the seed: the program's
        against the fp32 reference, or with ``fp8`` / ``tf32`` the
        control's (the reference in the lower precision, in the program's
        place) against the same."""
        from bench_port.lib import check
        k = mix(self.seed, 7) % len(self.rec.requests)
        return check.serve(self, k, fp8=fp8, tf32=tf32)
