"""Offline cone diagnostics (the JAX package's cli/cone_diagnostics.py):
per layer, cone = W .* dW from saved weights and gradients, drawn as
column-sparsity heatmap strips, each layer's mean column sparsity
printed; or, with --scores, the cone column scores the stage-1 trainer
writes with --with_grad_record (grad_records/step<N>.npz, (layers, out)
per projection, the same keys and shapes as the JAX trainer's) drawn as
they are.

Inputs are .npz or reference-format .safetensors files whose keys match
(composed weights and composed gradients per layer).

    python -m video_style_transfer_tpu_torch.cli.cone_diagnostics \\
        --scores out/unziplora/grad_records/step201.npz --output cone.png
"""
from __future__ import annotations

import argparse

import numpy as np


def load_arrays(path: str):
    if path.endswith(".npz"):
        with np.load(path) as f:
            return dict(f)
    if path.endswith(".safetensors"):
        from video_style_transfer_tpu_torch.utils import safetensors_io
        return safetensors_io.load_numpy(path)
    raise SystemExit(f"unsupported file type: {path}")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--weights")
    p.add_argument("--grads")
    p.add_argument("--scores", default=None,
                   help="a grad_records/step<N>.npz of the stage-1 trainer: "
                        "per-layer cone column scores, drawn as they are")
    p.add_argument("--output", default="cone_heatmap.png")
    p.add_argument("--threshold", type=float, default=1e-5)
    p.add_argument("--layers", nargs="*", default=None,
                   help="a subset of the layer keys (default: every key "
                        "the files share)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from video_style_transfer_tpu_torch.utils.observability import (
        cone_column_sparsity, cone_from_arrays, render_cone_heatmaps)

    if args.scores:
        scores = load_arrays(args.scores)
        keys = args.layers or sorted(scores)
        # the scores are already per-column aggregates: one (layers, out)
        # strip a projection
        strips = {k: scores[k].reshape(-1, scores[k].shape[-1])
                  for k in keys}
        out = render_cone_heatmaps(strips, args.output)
        print("wrote", out)
        return out
    if not args.weights or not args.grads:
        raise SystemExit("need --weights and --grads (or --scores)")
    w = load_arrays(args.weights)
    g = load_arrays(args.grads)
    keys = args.layers or sorted(set(w) & set(g))
    if not keys:
        raise SystemExit("no common layer keys between weights and grads")
    cones = {k: cone_from_arrays(w[k], g[k]) for k in keys}
    out = render_cone_heatmaps(cones, args.output)
    for k in keys:
        sp = cone_column_sparsity(cones[k], args.threshold)
        print(f"{k}: avg column sparsity {sp.mean():.4f}")
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
