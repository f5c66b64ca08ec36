"""The parity runbook (the JAX package's cli/verify_parity.py): the one
command to run when real SDXL weights and the reference's outputs are at
hand, on the card:

    python -m video_style_transfer_tpu_torch.cli.verify_parity \\
        --pretrained_model_name_or_path sdxl/ \\
        --unziplora_name_or_path artifacts/ --prompt "a sks dog in szn style" \\
        --reference_outputs ref_outputs/ --lpips lpips_vgg16.safetensors \\
        --report parity_report.json

Stages (each recorded in the JSON report; exit 0 only when every
evaluated gate passes):

 1. inventory: every key -> shape on disk (safetensors headers only; no
    tensor data is read) against the load contract of
    utils/hf_convert.py (``state_dict_shapes`` of the model trees built
    on the meta device, ``clip_source_shapes``): missing, unexpected and
    mismatched keys by component, before any load;
 2. load: ``cli.common.load_models`` (the converter's own shape checks);
 3. generate: ``cli.infer`` with the reference's settings (fixed seeds,
    fp32 decode) on the bundle the load stage built;
 4. compare: ``cli.compare_outputs`` for each reference file of the same
    name: PSNR and SSIM always, per-frame LPIPS and its <= 0.02 gate
    with ``--lpips``.

``make_synthetic_checkpoint`` writes the tiny diffusers-layout directory
the whole chain runs on without real weights (``--config_preset tiny``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Tuple

import numpy as np

# keys diffusers / transformers checkpoints carry that the converters
# ignore (not weights, or precomputed buffers)
IGNORABLE = ("position_ids", "logit_scale", "attn.masked_bias",
             "model_ema")


def safetensors_header(path: str) -> Dict[str, Tuple[int, ...]]:
    """key -> shape from a .safetensors header alone."""
    from video_style_transfer_tpu_torch.utils.safetensors_io import (
        read_header)
    header, _ = read_header(path)
    return {k: tuple(v["shape"]) for k, v in header.items()
            if k != "__metadata__"}


def dir_header(path: str) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            out.update(safetensors_header(os.path.join(path, fname)))
    if not out:
        raise FileNotFoundError(f"no .safetensors under {path}")
    return out


def diff_inventory(disk: Dict[str, Tuple[int, ...]],
                   contract: Dict[str, Tuple[int, ...]]) -> Dict:
    missing = sorted(set(contract) - set(disk))
    extra = sorted(set(disk) - set(contract))
    ignorable = [k for k in extra if any(t in k for t in IGNORABLE)]
    extra = [k for k in extra if k not in ignorable]
    mismatch = sorted(
        (k, list(disk[k]), list(contract[k]))
        for k in set(disk) & set(contract)
        if tuple(disk[k]) != tuple(contract[k]))
    return {
        "keys_on_disk": len(disk),
        "keys_in_contract": len(contract),
        "missing": missing,
        "unexpected": extra,
        "ignored_buffers": ignorable,
        "shape_mismatch": [
            {"key": k, "disk": d, "expected": e} for k, d, e in mismatch],
        "ok": not missing and not extra and not mismatch,
    }


def stage_inventory(model_dir: str, configs) -> Dict:
    """unet/ vae/ text_encoder/ text_encoder_2/ against the load contract,
    from the headers alone; the model trees are built on the meta device
    (shapes, no storage)."""
    from video_style_transfer_tpu_torch.models.layers import MetaInit
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.models.vae import (
        init_vae_decoder, init_vae_encoder)
    from video_style_transfer_tpu_torch.utils.hf_convert import (
        clip_source_shapes, state_dict_shapes)

    ucfg, vcfg, lcfg, gcfg = configs
    vae = init_vae_decoder(MetaInit(), vcfg)
    vae.update(init_vae_encoder(MetaInit(), vcfg))
    report = {
        "unet": diff_inventory(
            dir_header(os.path.join(model_dir, "unet")),
            state_dict_shapes(init_unet(MetaInit(), ucfg))),
        "vae": diff_inventory(dir_header(os.path.join(model_dir, "vae")),
                              state_dict_shapes(vae)),
        "text_encoder": diff_inventory(
            dir_header(os.path.join(model_dir, "text_encoder")),
            clip_source_shapes(lcfg)),
        "text_encoder_2": diff_inventory(
            dir_header(os.path.join(model_dir, "text_encoder_2")),
            clip_source_shapes(gcfg)),
    }
    report["ok"] = all(report[c]["ok"] for c in
                       ("unet", "vae", "text_encoder", "text_encoder_2"))
    return report


def make_synthetic_checkpoint(out_dir: str, seed: int = 0):
    """Write a tiny diffusers-layout checkpoint directory: seeded random
    UNet (without motion modules), VAE and CLIP weights of the
    ``tiny_checkpoint_configs`` topology as safetensors, and byte-level
    tokenizers under tokenizer/ and tokenizer_2/."""
    from video_style_transfer_tpu_torch.cli.common import (
        tiny_checkpoint_configs)
    from video_style_transfer_tpu_torch.data.tokenizer import (
        bytes_to_unicode)
    from video_style_transfer_tpu_torch.models.layers import Init
    from video_style_transfer_tpu_torch.models.unet import init_unet
    from video_style_transfer_tpu_torch.models.vae import (
        init_vae_decoder, init_vae_encoder)
    from video_style_transfer_tpu_torch.utils.hf_convert import (
        clip_source_shapes, export_to_state_dict)
    from video_style_transfer_tpu_torch.utils.safetensors_io import save_file

    ucfg, vcfg, lcfg, gcfg = tiny_checkpoint_configs()
    os.makedirs(os.path.join(out_dir, "unet"), exist_ok=True)
    save_file(export_to_state_dict(init_unet(Init(seed), ucfg)),
              os.path.join(out_dir, "unet",
                           "diffusion_pytorch_model.safetensors"))
    vae = init_vae_decoder(Init(seed + 1), vcfg)
    vae.update(init_vae_encoder(Init(seed + 2), vcfg))
    os.makedirs(os.path.join(out_dir, "vae"), exist_ok=True)
    save_file(export_to_state_dict(vae),
              os.path.join(out_dir, "vae",
                           "diffusion_pytorch_model.safetensors"))

    # CLIP weights straight from the load contract, ~N(0, 0.02) like
    # transformers' init
    rng = np.random.default_rng(seed)
    for sub, cfg in (("text_encoder", lcfg), ("text_encoder_2", gcfg)):
        sd = {k: rng.normal(0, 0.02, s).astype(np.float32)
              for k, s in clip_source_shapes(cfg).items()}
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        save_file(sd, os.path.join(out_dir, sub, "model.safetensors"))

    # byte-level tokenizers: every single byte is a token, no merges (a
    # valid BPE; 256 + 256 "</w>" + bos/eos = 514 ids fit the tiny
    # vocabulary of 1000)
    syms = list(bytes_to_unicode().values())
    vocab = {}
    for s in syms:
        vocab[s] = len(vocab)
    for s in syms:
        vocab[s + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    for sub in ("tokenizer", "tokenizer_2"):
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
    return out_dir


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", required=True)
    p.add_argument("--pretrained_vae_model_name_or_path", default=None)
    p.add_argument("--unziplora_name_or_path", default=None)
    p.add_argument("--unziplora_name", default="unziplora")
    p.add_argument("--prompt", default=None,
                   help="generation prompt (the reference run's own); "
                        "without one the runbook stops after the "
                        "inventory")
    p.add_argument("--mode", default=None,
                   choices=["both", "content", "style", "base"],
                   help="default: both with --unziplora_name_or_path, "
                        "else base")
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[0, 1000, 111, 1234],
                   help="the reference's fixed seeds")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=5.0)
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--sampler", default="euler", choices=["euler", "dpm"])
    p.add_argument("--reference_outputs", default=None,
                   help="directory of the reference's images named like "
                        "ours ({mode}_seed{N}.png); enables the compare "
                        "stage")
    p.add_argument("--lpips", default=None, metavar="WEIGHTS",
                   help="VGG16 + heads LPIPS weight file; enables the "
                        "per-frame LPIPS gate")
    p.add_argument("--lpips_gate", type=float, default=0.02)
    p.add_argument("--psnr_min", type=float, default=None,
                   help="a PSNR gate (dB) for runs without LPIPS weights")
    p.add_argument("--output_dir", default="out/verify_parity")
    p.add_argument("--report", default="parity_report.json")
    p.add_argument("--config_preset", default="sdxl",
                   choices=["sdxl", "tiny"],
                   help="tiny: the synthetic checkpoint's topology")
    p.add_argument("--stop_after", default=None,
                   choices=["inventory", "load", "generate"],
                   help="run the stages up to this one")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card is an "
                        "error")
    return p


def main(argv=None):
    import torch

    from video_style_transfer_tpu_torch.cli import common

    args = build_parser().parse_args(argv)
    tiny = args.config_preset == "tiny"
    if tiny:
        configs = common.tiny_checkpoint_configs()
    else:
        configs = common.model_configs(False, False)

    report = {"model_dir": args.pretrained_model_name_or_path,
              "stages": {}}
    ok = True

    # 1. inventory
    inv = stage_inventory(args.pretrained_model_name_or_path, configs)
    report["stages"]["inventory"] = inv
    ok &= inv["ok"]
    print(f"[1/4] inventory: {'OK' if inv['ok'] else 'MISMATCH'}")
    for comp in ("unet", "vae", "text_encoder", "text_encoder_2"):
        c = inv[comp]
        print(f"      {comp}: {c['keys_on_disk']} keys on disk, "
              f"{len(c['missing'])} missing, "
              f"{len(c['unexpected'])} unexpected, "
              f"{len(c['shape_mismatch'])} shape mismatches")
    if args.stop_after == "inventory" or not inv["ok"] \
            or args.prompt is None:
        if args.prompt is None and inv["ok"] \
                and args.stop_after != "inventory":
            print("      (no --prompt: stopping after inventory)")
        return _finish(report, args, ok)

    # 2. load (in the dtype cli.infer serves the preset in)
    device = common.resolve_device(args.device)
    try:
        bundle = common.load_models(
            args.pretrained_model_name_or_path, motion=False,
            dtype=torch.float32 if tiny else torch.bfloat16, device=device,
            vae_path=args.pretrained_vae_model_name_or_path,
            configs=configs if tiny else None)
        report["stages"]["load"] = {"ok": True}
        print("[2/4] load: OK (converter shape checks passed)")
    except Exception as e:  # noqa: BLE001 — reported, the gate fails
        report["stages"]["load"] = {"ok": False, "error": str(e)[:500]}
        print(f"[2/4] load: FAILED: {e}")
        return _finish(report, args, False)
    if args.stop_after == "load":
        return _finish(report, args, ok)

    # 3. generate, through the serving CLI
    from video_style_transfer_tpu_torch.cli import infer
    mode = args.mode or ("both" if args.unziplora_name_or_path else "base")
    gen_argv = [
        "--pretrained_model_name_or_path",
        args.pretrained_model_name_or_path,
        "--prompt", args.prompt, "--mode", mode,
        "--num_inference_steps", str(args.num_inference_steps),
        "--guidance_scale", str(args.guidance_scale),
        "--resolution", str(args.resolution), "--sampler", args.sampler,
        "--config_preset", args.config_preset,
        "--output_dir", args.output_dir, "--device", str(device),
        "--seeds", *[str(s) for s in args.seeds]]
    if args.pretrained_vae_model_name_or_path:
        # on the argv for the report; the bundle already holds that VAE
        gen_argv += ["--pretrained_vae_model_name_or_path",
                     args.pretrained_vae_model_name_or_path]
    if args.unziplora_name_or_path:
        gen_argv += ["--unziplora_name_or_path", args.unziplora_name_or_path,
                     "--unziplora_name", args.unziplora_name]
    # the load stage's bundle: the checkpoint is read and converted once
    outs = infer.main(gen_argv, bundle=bundle)
    del bundle
    report["stages"]["generate"] = {"ok": True, "outputs": outs,
                                    "mode": mode}
    print(f"[3/4] generate: {len(outs)} image(s) -> {args.output_dir}")
    if args.stop_after == "generate" or not args.reference_outputs:
        if not args.reference_outputs and args.stop_after != "generate":
            print("      (no --reference_outputs: compare skipped)")
        return _finish(report, args, ok)

    # 4. compare against the reference's outputs
    from video_style_transfer_tpu_torch.cli import compare_outputs
    comps = []
    gates_ok = True
    for out in outs:
        ref = os.path.join(args.reference_outputs, os.path.basename(out))
        if not os.path.exists(ref):
            comps.append({"ours": out, "reference": None,
                          "skipped": "no matching reference file"})
            continue
        cmp_argv = ["--ours", out, "--reference", ref, "--device",
                    str(device)]
        if args.lpips:
            cmp_argv += ["--lpips", args.lpips]
        row = compare_outputs.main(cmp_argv)
        row = {k: v for k, v in row.items() if k != "per_frame"}
        row.update(ours=out, reference=ref)
        if args.lpips:
            row["lpips_gate"] = row["lpips_max"] <= args.lpips_gate
            gates_ok &= row["lpips_gate"]
        if args.psnr_min is not None:
            row["psnr_gate"] = row["psnr_mean"] >= args.psnr_min
            gates_ok &= row["psnr_gate"]
        comps.append(row)
    matched = [c for c in comps if "skipped" not in c]
    gates_ok &= bool(matched)
    report["stages"]["compare"] = {
        "ok": gates_ok, "pairs": comps,
        "lpips_gate_evaluated": bool(args.lpips),
        "lpips_gate_threshold": args.lpips_gate}
    ok &= gates_ok
    print(f"[4/4] compare: {len(matched)}/{len(comps)} matched, "
          f"gates {'PASS' if gates_ok else 'FAIL'}"
          + ("" if args.lpips else
             "  (LPIPS gate not evaluated: pass --lpips to enable the "
             "<= 0.02 gate)"))
    return _finish(report, args, ok)


def _finish(report, args, ok) -> int:
    """Write the report; the exit code (0: every evaluated gate
    passed)."""
    report["ok"] = bool(ok)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"verdict: {'PASS' if ok else 'FAIL'} -> {args.report}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
