"""Diffusion noise schedule (SDXL scaled_linear, 1000 steps) as host
numpy tables."""
from __future__ import annotations

import numpy as np


def make_schedule(num_train_timesteps: int = 1000,
                  beta_start: float = 0.00085, beta_end: float = 0.012):
    """scaled_linear betas; returns a dict of tables (fp64 setup, fp32
    tables)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    return {
        "num_train_timesteps": num_train_timesteps,
        "betas": betas.astype(np.float32),
        "alphas_cumprod": alphas_cumprod.astype(np.float32),
    }
