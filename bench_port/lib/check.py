"""The comparisons that decide ``correct``, run after the window on what
the timed path produced (``drivers/serve.py``'s recorder), against the
plain reference (``bench_port/reference``), which works out again
everything the program derived (conditioning, folded LoRA, schedule).

Serving readings of one request, drawn from the seed:

- ``start``: elements of the first step's latents that differ from the
  reference's noise draw times the initial sigma (exact);
- ``euler``: elements, over every step, where the program's Euler result
  differs from the reference's float32 Euler update of the same state
  and eps, or where a step's state is not the last step's result, or its
  sigmas not the schedule's (exact);
- ``eps``: the largest relative L2 gap, over steps drawn from the seed,
  of the program's guided eps from the reference's at the same state:
  text encoders, LoRA, UNet (with motion modules) and guidance in one;
- ``decode``: the largest relative L2 gap of the decoder's pixels from
  the reference decoder's at the same latents, a frame (or row) a call;
- ``frames``: elements where the decoder's input is not the sampler's
  result, or the returned uint8 frames are not those pixels quantised
  (exact).

With ``fp8`` / ``tf32`` the control takes the program's place for
``eps`` (the reference with its bf16 models' products on e4m3 operands)
and ``decode`` (the reference decoder on TF32), and only those two are
read.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench_port.reference import models as ref
from bench_port.reference import pipeline as refpipe


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@contextlib.contextmanager
def tf32():
    """TF32 on for matmuls and convolutions inside, as it was after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _conditioning(d, k, nx):
    """(cond, uncond) as (ctx triple, pooled, time_ids), one row per
    clip of the CFG half, from the reference's own text encoders."""
    t, c, dev = d.traffic, d.cfg, d.device
    p = d.prompts[k]
    emb, pooled = refpipe.encode(d.w, c, p["prompt"], dev, nx)
    emb_c = emb_s = None
    if p.get("content") is not None:
        emb_c, _ = refpipe.encode(d.w, c, p["content"], dev, nx)
    if p.get("style") is not None:
        emb_s, _ = refpipe.encode(d.w, c, p["style"], dev, nx)
    neg, neg_pooled = refpipe.encode(d.w, c, t["negative_prompt"], dev, nx)
    ids = refpipe.time_ids(t["height"], t["width"], dev)
    n = 1 if d.video else len(t["noise_seeds"])

    def rep(x):
        return None if x is None else x.repeat((n,) + (1,) * (x.dim() - 1))
    cond = (tuple(rep(e) for e in (emb, emb_c, emb_s)), rep(pooled),
            rep(ids))
    uncond = ((rep(neg),) * 3, rep(neg_pooled), rep(ids))
    return cond, uncond


@torch.no_grad()
def serve(d, k: int, fp8: bool = False, tf32: bool = False):
    t, c = d.traffic, d.cfg
    req = d.rec.requests[k]
    steps = req["steps"]
    ts, sig, init = refpipe.euler_table(t["steps"])
    frames = t["frames"] if d.video else 1
    control = fp8 or tf32
    out = {}
    if not control:
        rows = t["frames"] if d.video else len(t["noise_seeds"])
        f = 2 ** (len(c["vae"]["block_out_channels"]) - 1)
        shape = (rows, t["height"] // f, t["width"] // f,
                 c["unet"]["in_channels"])
        seeds = d.noise_seeds[k][:1] if d.video else d.noise_seeds[k]
        x0 = refpipe.start_latents(seeds, shape, d.device, d.dtype, init)
        out["start"] = (int((x0 != steps[0][0]).sum()) if steps
                        else x0.numel())
        bad = abs(len(steps) - t["steps"]) * x0.numel()
        prev = None
        for j, (s, e, sg, sgn, res) in enumerate(steps[:t["steps"]]):
            if prev is not None:
                bad += int((s != prev).sum())
            if sg != float(sig[j]) or sgn != float(sig[j + 1]):
                bad += res.numel()
            bad += int((refpipe.euler_step(s, e, sig[j], sig[j + 1])
                        != res).sum())
            prev = res
        out["euler"] = bad
    rng = np.random.default_rng([d.seed, k, 11])
    picks = sorted(rng.choice(len(steps), min(d.spec["eps_steps"],
                                              len(steps)), replace=False))
    cond, uncond = _conditioning(d, k, ref.FP32)
    if fp8:
        cond8, uncond8 = _conditioning(d, k, ref.Numerics(fp8=True))
    gaps = []
    kw = dict(scale=t["guidance_scale"], frames=frames, mode=t["mode"],
              state=d.w["state"])
    for j in picks:
        s, e = steps[j][0], steps[j][1]
        want = refpipe.cfg_eps(d.w, c, cond, uncond, s, ts[j], sig[j], **kw)
        if fp8:
            e = refpipe.cfg_eps(d.w, c, cond8, uncond8, s, ts[j], sig[j],
                                nx=ref.Numerics(fp8=True), **kw)
        if not control or fp8:
            gaps.append(rel(e, want))
        del want
    if gaps:
        out["eps"] = max(gaps)
    if control and not tf32:
        return out
    final = steps[-1][4] if steps else None
    dgaps, fbad, row = [], 0, 0
    for z, y in req["decodes"]:
        for r in range(z.shape[0]):
            want = ref.vae_decode(d.w["vae"], c["vae"], z[r:r + 1])
            if tf32:
                with tf32():
                    y_r = ref.vae_decode(d.w["vae"], c["vae"], z[r:r + 1])
            else:
                y_r = y[r:r + 1]
            dgaps.append(rel(y_r, want))
            del want
        if not control:
            n = z.shape[0]
            if final is None or row + n > final.shape[0]:
                fbad += z.numel()
            else:
                fbad += int((z.float() != final[row:row + n].float()).sum())
            fbad += int((refpipe.to_uint8(y).cpu()
                         != req["frames"][row:row + n]).sum())
            row += n
    out["decode"] = max(dgaps) if dgaps else float("inf")
    if not control:
        if final is None or row != final.shape[0]:
            fbad += 1
        out["frames"] = fbad
    return out
