"""Observability of the trainers (the JAX package's
utils/observability.py): the cone diagnostics, per-block LoRA norm and
merger scalars, the metrics sinks and a profiler trace.

- cone_from_arrays, cone_column_sparsity and render_cone_heatmaps: the
  offline cone analysis (W .* dW, each column's share of rows above a
  threshold, heatmap strips; matplotlib is imported when drawing);
- lora_norm_log and lora_merge_log: the mean composed-LoRA norm and
  merger value of each block group, the stage-1 trainer's logged
  scalars;
- MetricsLogger appends one JSON line per logged step to
  ``<log_dir>/metrics.jsonl`` and, where asked for and where they import,
  writes the same scalars (and validation images) to tensorboard
  (``torch.utils.tensorboard``) and wandb (offline unless ``WANDB_MODE``
  says otherwise), as the reference's trackers do. ``enabled=False``
  opens and writes nothing;
- start_profiler_trace / stop_profiler_trace: the port's one exporter,
  a ``torch.profiler`` trace of the process (CPU, and CUDA where there
  is a card) written as a Chrome trace under the log directory, with
  the program's spans (``utils.tracing``, which records while the
  profiler runs) on a track of their own on the same time base, and
  ``idle_gaps.json`` beside it: the device's idle stretches over the
  session, each with the span that was open when it began.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from video_style_transfer_tpu_torch.lora.surgery import (
    PROJS, iter_spatial_attention_paths, tree_get)
from video_style_transfer_tpu_torch.lora.unzip import composed_delta


def cone_from_arrays(weight, grad) -> np.ndarray:
    """cone = W .* dW elementwise."""
    return np.asarray(weight) * np.asarray(grad)


def cone_column_sparsity(cone, threshold: float = 1e-5) -> np.ndarray:
    """The fraction of rows of each column with |cone| above
    threshold."""
    cone = np.asarray(cone)
    return (np.abs(cone) > threshold).sum(axis=0) / cone.shape[0]


def render_cone_heatmaps(cone_by_layer: Dict[str, np.ndarray],
                         out_path: Optional[str] = None):
    """One column-sparsity strip per layer, sorted by name. Returns the
    figure, or saves it to out_path and returns the path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = max(len(cone_by_layer), 1)
    fig, axes = plt.subplots(n, 1, figsize=(10, 1.2 * n), squeeze=False)
    if not cone_by_layer:
        axes[0, 0].axis("off")
    for ax, (name, cone) in zip(axes[:, 0], sorted(cone_by_layer.items())):
        ax.imshow(cone_column_sparsity(cone)[None, :], aspect="auto",
                  cmap="viridis", vmin=0, vmax=1)
        ax.set_yticks([])
        ax.set_title(name, fontsize=6, loc="left")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
    return fig


def _block_group(path) -> str:
    """The "down_blocks.1.attentions.0" grouping key of an attention
    path: its keys before "transformer_blocks"."""
    parts = []
    for k in path:
        if k == "transformer_blocks":
            break
        parts.append(str(k))
    return ".".join(parts)


def _lora_projections(params):
    for path in iter_spatial_attention_paths(params):
        attn = tree_get(params, path)
        for proj in PROJS:
            if "lora" in attn[proj]:
                yield path, attn[proj]["lora"]


@torch.no_grad()
def lora_norm_log(params, branch: str, *, with_merge: bool = False,
                  norm: str = "L2") -> Dict[str, float]:
    """{"<branch>_<block group>_norm": the mean norm of the composed
    (in, out) LoRA delta of every layer and projection of the group}:
    "L2" the Frobenius norm, "L1" the sum of magnitudes."""
    groups: Dict[str, list] = {}
    for path, lp in _lora_projections(params):
        d = composed_delta(lp, branch, with_merge).float()
        val = d.abs().sum() if norm == "L1" else torch.sqrt((d * d).sum())
        groups.setdefault(f"{branch}_{_block_group(path)}_norm",
                          []).append(val)
    return {k: float(torch.stack(v).mean()) for k, v in groups.items()}


@torch.no_grad()
def lora_merge_log(params, branch: str) -> Dict[str, float]:
    """{"<branch>_<block group>_merge": the mean merger value of the
    group's layers and projections}."""
    groups: Dict[str, list] = {}
    for path, lp in _lora_projections(params):
        groups.setdefault(f"{branch}_{_block_group(path)}_merge",
                          []).append(lp[f"merge_{branch}"].float().mean())
    return {k: float(torch.stack(v).mean()) for k, v in groups.items()}


class MetricsLogger:
    """JSONL scalar sink plus optional tensorboard and wandb. enabled
    None (the default): on process 0 only, as the reference gates its
    trackers on the main process; every other process writes nothing."""

    def __init__(self, log_dir: str, *, use_tensorboard: bool = False,
                 use_wandb: bool = False, project: str = "vst-torch",
                 enabled: Optional[bool] = None):
        if enabled is None:
            from video_style_transfer_tpu_torch.parallel.distributed import (
                is_main_process)
            enabled = is_main_process()
        self.enabled = enabled
        self.path = None
        self._f = self._tb = self._wandb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"tensorboard unavailable ({e}); logging to "
                      f"{self.path} only", file=sys.stderr)
            else:
                self._tb = SummaryWriter(log_dir)
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                print(f"wandb unavailable ({e}); logging to {self.path} "
                      f"only", file=sys.stderr)
            else:
                self._wandb = wandb.init(
                    project=project, dir=log_dir,
                    mode=os.environ.get("WANDB_MODE", "offline"))

    def log(self, step: int, scalars: Dict[str, float]):
        if not self.enabled:
            return
        clean = {k: float(v) for k, v in scalars.items()}
        self._f.write(json.dumps({"step": int(step), "time": time.time(),
                                  **clean}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(clean, step=step)

    def log_images(self, step: int, images: Dict[str, np.ndarray]):
        """Validation images (name -> (H, W, 3) uint8, or float in [0,
        1]) to the trackers; metrics.jsonl gets a line naming them."""
        if not self.enabled:
            return
        for name, img in images.items():
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            if self._tb is not None:
                self._tb.add_image(name, arr, step, dataformats="HWC")
            if self._wandb is not None:
                import wandb
                self._wandb.log({name: wandb.Image(arr)}, step=step)
        self._f.write(json.dumps({"step": int(step), "time": time.time(),
                                  "validation_images": sorted(images)})
                      + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        self._f = self._tb = self._wandb = None


# the trace start_profiler_trace opened: one a process, as a profiler
# trace is (the JAX package's hooks wrap jax.profiler's global trace)
_TRACE = {}


def start_profiler_trace(log_dir: str):
    """Start tracing this process (CPU, and CUDA where available) into
    log_dir; raises if a trace is already open."""
    from torch.profiler import ProfilerActivity, profile
    if _TRACE:
        raise RuntimeError("a profiler trace is already open")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _TRACE.update(prof=prof, dir=log_dir, start=time.time_ns())


def stop_profiler_trace() -> str:
    """Stop the open trace; returns the Chrome trace file written under
    its log_dir (``idle_gaps.json`` beside it)."""
    from video_style_transfer_tpu_torch.utils import tracing
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("dir")
    lo, hi = _TRACE.pop("start"), time.time_ns()
    prof.stop()
    spans = [s for s in tracing.read() if s.start is not None
             and s.end is not None and s.start >= lo and s.end <= hi]
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(tracing.chrome_events(
        spans, trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
    events = tracing.device_events(prof)
    gaps = tracing.idle_gaps(events, spans, lo * 1e-9, hi * 1e-9)
    window = (hi - lo) * 1e-9
    idle = sum(g[1] for g in gaps) if events else None
    with open(os.path.join(log_dir, "idle_gaps.json"), "w") as f:
        json.dump({"window_s": window, "device_events": len(events),
                   "idle_s": idle,
                   "by_span": tracing.gap_totals(gaps) if events else {},
                   "gaps": [{"start_s": t, "ms": length * 1e3, "span": n}
                            for t, length, n in gaps] if events else []},
                  f)
    return path
