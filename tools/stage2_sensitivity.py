#!/usr/bin/env python3
"""The frame-parallel stage-2 forward against one process's, layer by
layer, beside one process against itself with its inputs nudged by one
ulp.

    python3 tools/stage2_sensitivity.py [--out FILE]

Needs one CUDA card. Runs ``cli.train_animatediff``'s trainer at
chip_smoke.py's multi-process stage-2 cut (SDXL + AnimateDiff-XL widths
and depth, seeded weights, one 8-frame clip at 512^2 from the seeded
video in memory) in fp32 (``--mixed_precision no``), with each stage-1
LoRA that cut could train: the trainer's seeded rank-4 fallback (no
``--unziplora_name_or_path``) and chip_smoke.py's rank-64 artifact set
(up factors x 0.5). For each, the first step's forward (its draws,
before any update; the step stops at the loss) runs

- A: in one process,
- B: in one process, the clip latents nudged by one ulp toward +inf,
- C: in two processes with ``--frame_parallel 2`` (two ranks on the one
  card over gloo, as chip_smoke.py's multi-process section runs them),

keeping every motion module's input and output and the UNet's output.
Prints, per layer, the normwise distance of B and of C (each rank's
frames) from A, and the three losses; writes the same as one JSON object
to FILE (default out/stage2_sensitivity.json). Where C's
distance stays of the order of B's, the two-rank path differs from one
process by rounding that the model amplifies; a layer where C's distance
jumps while B's does not is where the two-rank path computes something
else.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (constants and helpers; no torch)

LORAS = ("seeded", "artifacts")
WORLD = 2


class _Stop(Exception):
    """Raised at the loss: the probe reads the forward only."""


def _trainer(cfg, lora, frame_parallel):
    from video_style_transfer_tpu_torch.cli import train_animatediff as ta
    flags = ["--device", "cuda:0", "--mixed_precision", "no"]
    if frame_parallel:
        flags += ["--frame_parallel", str(WORLD)]
    if lora == "artifacts":
        flags += ["--unziplora_name_or_path", cfg["artifacts"]]
    out = os.path.join(cfg["root"],
                       f"{lora}_{'two' if frame_parallel else 'one'}")
    args = ta.build_parser().parse_args(cs.mp_stage2_args(out, flags))
    tr = ta.prepare(args, cs.ArrayClips(cs.mp_video(), cs.TRAIN_FRAMES))
    return tr, ta.sample_micro_batches(tr, 0)


def _forward(tr, micro, gen_state):
    """The first step's forward from generator state `gen_state`: the
    local loss and [(layer name, fp32 CPU tensor)] in call order."""
    import torch
    from video_style_transfer_tpu_torch.models import unet
    from video_style_transfer_tpu_torch.training import stage2

    layers, out = [], {}
    orig_mm, orig_unet = unet.motion_module, stage2.unet_apply
    orig_loss = stage2.stage2_loss

    def motion_module(p, x, **kw):
        y = orig_mm(p, x, **kw)
        k = len(layers) // 2
        c = x.shape[-1]
        layers.append((f"motion {k} ({c} ch) in", x.detach().float().cpu()))
        layers.append((f"motion {k} ({c} ch) out", y.detach().float().cpu()))
        return y

    def unet_apply(*a, **kw):
        y = orig_unet(*a, **kw)
        layers.append(("unet out", y.detach().float().cpu()))
        return y

    def stage2_loss(*a, **kw):
        loss, _ = orig_loss(*a, **kw)
        out["loss"] = float(loss.detach())
        raise _Stop

    unet.motion_module, stage2.unet_apply = motion_module, unet_apply
    stage2.stage2_loss = stage2_loss
    tr.generator.set_state(gen_state)
    try:
        tr.step(tr.params, micro, tr.generator)
    except _Stop:
        pass
    finally:
        unet.motion_module, stage2.unet_apply = orig_mm, orig_unet
        stage2.stage2_loss = orig_loss
    return out["loss"], layers


def _sq(a, b=None):
    d = a.double() if b is None else a.double() - b.double()
    return float(d.square().sum())


def one_process(cfg):
    """A and B for each LoRA; A's layers saved for the ranks."""
    import torch
    res = {}
    for lora in LORAS:
        t0 = time.perf_counter()
        tr, micro = _trainer(cfg, lora, False)
        state = tr.generator.get_state()
        loss_a, a = _forward(tr, micro, state)
        nudged = [{**m, "latents": torch.nextafter(
            m["latents"], torch.full_like(m["latents"], float("inf")))}
            for m in micro]
        loss_b, b = _forward(tr, nudged, state)
        torch.save(a, os.path.join(cfg["root"], f"{lora}_A.pt"))
        res[lora] = {"loss_a": loss_a, "loss_b": loss_b,
                     "layers": [[name, _sq(x), _sq(y, x)]
                                for (name, x), (_, y) in zip(a, b)],
                     "s": time.perf_counter() - t0}
        del tr, micro, nudged, a, b
        torch.cuda.empty_cache()
    return res


def rank_process(cfg, rank):
    """C for each LoRA on this rank: its local loss and, per layer, the
    squared distance of its frames from A's and A's squared norm there."""
    import torch
    res = {}
    for lora in LORAS:
        t0 = time.perf_counter()
        tr, micro = _trainer(cfg, lora, True)
        shard = tr.grid.frame_shard(tr.frames)
        rows = shard.slice()
        loss_c, c = _forward(tr, micro, tr.generator.get_state())
        a = torch.load(os.path.join(cfg["root"], f"{lora}_A.pt"))
        if [n for n, _ in a] != [n for n, _ in c]:
            raise SystemExit(f"rank {rank}: layers {[n for n, _ in c]} against "
                             f"{[n for n, _ in a]}")
        res[lora] = {"loss_c": loss_c,
                     "layers": [[name, _sq(x[rows]), _sq(y, x[rows])]
                                for (name, x), (_, y) in zip(a, c)],
                     "s": time.perf_counter() - t0}
        del tr, micro, a, c
        torch.cuda.empty_cache()
    return res


def child(kind, config_path, rank):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    with open(config_path) as f:
        cfg = json.load(f)
    if kind == "one":
        res = one_process(cfg)
    else:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method="file://" + cfg["store"],
                                world_size=WORLD, rank=rank)
        res = rank_process(cfg, rank)
        dist.destroy_process_group()
    with open(os.path.join(cfg["root"], f"{kind}{rank}.json"), "w") as f:
        json.dump(res, f)


def run(cfg, kind, ranks, timeout=600):
    """Start one child per rank, wait for all; a failed one fails the
    run."""
    path = os.path.join(cfg["root"], "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--child", kind, path, str(r)], cwd=HERE)
             for r in range(ranks)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            cs.fail(f"{kind} child {r} exited with {p.returncode}")
    out = []
    for r in range(ranks):
        with open(os.path.join(cfg["root"], f"{kind}{r}.json")) as f:
            out.append(json.load(f))
    return out


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        return child(sys.argv[2], sys.argv[3], int(sys.argv[4]))
    out_file = os.path.join(HERE, "out", "stage2_sensitivity.json")
    if len(sys.argv) == 3 and sys.argv[1] == "--out":
        out_file = sys.argv[2]
    elif len(sys.argv) != 1:
        cs.fail(f"usage: {sys.argv[0]} [--out FILE]")
    import torch
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available")
    card = cs.card_line()
    print(card, flush=True)
    from video_style_transfer_tpu_torch.config import UNetConfig
    from video_style_transfer_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.library()
    with tempfile.TemporaryDirectory(prefix="stage2_sensitivity_") as tmp:
        cfg = {"root": tmp, "store": os.path.join(tmp, "store"),
               "artifacts": os.path.join(tmp, "artifacts")}
        cs.write_lora_artifacts(cfg["artifacts"], UNetConfig.sdxl(),
                                rank=cs.LORA_RANK, seed=11, device="cuda",
                                up_scale=0.5)
        torch.cuda.empty_cache()
        one = run(cfg, "one", 1)[0]
        two = run(cfg, "two", WORLD)
    readings = {"card": card, "resolution": cs.MP_TRAIN_RES,
                "frames": cs.TRAIN_FRAMES, "precision": "fp32"}
    for lora in LORAS:
        o = one[lora]
        loss_c = sum(r[lora]["loss_c"] for r in two)
        rows = []
        for i, (name, a_sq, b_sq) in enumerate(o["layers"]):
            a_r = sum(r[lora]["layers"][i][1] for r in two)
            c_sq = sum(r[lora]["layers"][i][2] for r in two)
            rows.append({"layer": name,
                         "nudged_one_ulp": (b_sq / a_sq) ** 0.5,
                         "two_ranks": (c_sq / a_r) ** 0.5})
        rd = readings[lora] = {
            "loss_one": o["loss_a"], "loss_nudged": o["loss_b"],
            "loss_two_ranks": loss_c,
            "loss_rel_nudged": abs(o["loss_b"] - o["loss_a"]) / o["loss_a"],
            "loss_rel_two_ranks": abs(loss_c - o["loss_a"]) / o["loss_a"],
            "layers": rows,
            "s": [o["s"]] + [r[lora]["s"] for r in two]}
        print(f"{lora} LoRA, fp32, {cs.TRAIN_FRAMES} frames at "
              f"{cs.MP_TRAIN_RES}^2, first step's forward: loss one process "
              f"{rd['loss_one']!r}, nudged by one ulp {rd['loss_nudged']!r} "
              f"(relative {rd['loss_rel_nudged']:.3e}), two ranks "
              f"{rd['loss_two_ranks']!r} (relative "
              f"{rd['loss_rel_two_ranks']:.3e}); normwise from one process "
              f"by layer (nudged, two ranks):", flush=True)
        for r in rows:
            print(f"  {r['layer']:<24} {r['nudged_one_ulp']:.3e}  "
                  f"{r['two_ranks']:.3e}", flush=True)
    readings["s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(readings, f, indent=1)
    print(json.dumps({k: readings[k] for k in ("card", "s")}), flush=True)


if __name__ == "__main__":
    main()
