"""Metrics sinks of the trainers (the JAX package's
utils/observability.py, its MetricsLogger and StepTimer).

MetricsLogger appends one JSON line per logged step to
``<log_dir>/metrics.jsonl`` and, where asked for and where they import,
writes the same scalars to tensorboard (``torch.utils.tensorboard``) and
wandb (offline unless ``WANDB_MODE`` says otherwise), as the reference's
trackers do. ``enabled=False`` opens and writes nothing.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict


class MetricsLogger:
    """JSONL scalar sink plus optional tensorboard and wandb."""

    def __init__(self, log_dir: str, *, use_tensorboard: bool = False,
                 use_wandb: bool = False, project: str = "vst-torch",
                 enabled: bool = True):
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

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        self._f = self._tb = self._wandb = None


class StepTimer:
    """Host wall-clock seconds between laps."""

    def __init__(self):
        self._last = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt, self._last = now - self._last, now
        return dt
