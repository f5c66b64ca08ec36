"""Learning-rate schedules of diffusers' get_scheduler (the JAX package's
training/schedules.py, as host functions step -> learning rate):

- constant: lr (no warmup: HF's 'constant' ignores it);
- constant_with_warmup: linear 0 -> lr over `warmup`, then lr;
- linear: warmup, then lr -> 0 at total_steps;
- cosine: warmup, then 0.5 * (1 + cos(pi * progress)) (HF's fixed
  num_cycles = 0.5);
- cosine_with_restarts: `num_cycles` hard restarts;
- polynomial: (lr - lr_end) * (1 - progress) ** power + lr_end.

The optimizer reads the schedule at its update count before the
increment, as optax does, so with warmup the first update is zero.
"""
from __future__ import annotations

import math

import numpy as np

NAMES = ("constant", "constant_with_warmup", "linear", "cosine",
         "cosine_with_restarts", "polynomial")


def make_lr_schedule(name: str, lr: float, *, warmup: int = 0,
                     total_steps: int = 1000, num_cycles: int = 1,
                     power: float = 1.0, lr_end: float = 1e-7):
    if name not in NAMES:
        raise ValueError(f"unknown lr_scheduler {name!r}; one of {NAMES}")
    warmup = max(int(warmup), 0)
    total = max(int(total_steps), warmup + 1)

    def schedule(step: int) -> float:
        step = float(step)
        warm = min(step / max(warmup, 1), 1.0) if warmup > 0 else 1.0
        # not clamped above 1: HF evaluates past num_training_steps too
        progress = max((step - warmup) / max(total - warmup, 1), 0.0)
        if name == "constant":
            return float(np.float32(lr))
        if name == "polynomial":
            decay = (lr - lr_end) * (1.0 - min(progress, 1.0)) ** power \
                + lr_end
            if step > total:
                decay = lr_end
            return float(np.float32(lr * warm if step < warmup else decay))
        if name == "constant_with_warmup":
            mult = 1.0
        elif name == "linear":
            mult = max(1.0 - progress, 0.0)
        elif name == "cosine":
            mult = max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))
        else:  # cosine_with_restarts
            frac = (num_cycles * progress) % 1.0
            mult = 0.0 if progress >= 1.0 else max(
                0.0, 0.5 * (1.0 + math.cos(math.pi * frac)))
        return float(np.float32(lr * (warm if step < warmup else mult)))

    return schedule
